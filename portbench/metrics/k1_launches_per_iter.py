"""K1 launches per outer iteration: the wrapper's own counter
(``dia_spmv.launches``, a chained FSAI apply counted once) over the
window, divided by the window's outer iterations.  A CPU run launches
nothing and reads nothing."""


def read(ctx):
    n = ctx.counters.get("dia_spmv", {}).get("launches", 0)
    iters = sum(s.iters for s in ctx.solves)
    return n / iters if n and iters else None
