"""Outer iterations to the tolerance (``RASResult.iters``: the RAS loop's
passes, or FGMRES's iterations), the median over the window's solves."""

import numpy as np


def read(ctx):
    if not ctx.solves:
        return None
    return float(np.median([s.iters for s in ctx.solves]))
