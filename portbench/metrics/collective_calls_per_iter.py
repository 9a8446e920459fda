"""The mesh layer's collectives per outer iteration: process 0's
``Mesh.stats["calls"]`` over the window (``all_gather``, ``psum``,
``shift`` across processes), over the window's outer iterations.  A run
of one process makes no collective and reads nothing."""


def read(ctx):
    m = ctx.mesh
    iters = sum(s.iters for s in ctx.solves)
    if not m or not m["calls"] or not iters:
        return None
    return m["calls"] / iters
