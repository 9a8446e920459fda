"""``solve_s`` of the cells whose solves the host bounds, as a per-layer
metric: the window's whole wall time over its solves, as ``solve_s``
reads it.  The host's speed spreads these cells' runs too widely (the
middle half of six runs up to 15% of the median) for an end-to-end bound;
``solve_s.p90`` is their end-to-end metric, and this reading says how
much of a change in it is the mean's."""


def read(ctx):
    return ctx.window_s / len(ctx.solves) if ctx.solves else None
