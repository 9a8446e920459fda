"""The 90th percentile of the wall times of all the window's solves
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    if not ctx.solves:
        return None
    return float(np.percentile([s.wall_s for s in ctx.solves], 90))
