"""Seconds per solve: the window's whole wall time over the solves
completed in it, each ``set_rhs`` and the entry up to the solution on the
host.  A rate over all the work, not a median of pieces."""


def read(ctx):
    return ctx.window_s / len(ctx.solves) if ctx.solves else None
