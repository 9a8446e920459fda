"""The mesh layer's host milliseconds per outer iteration: process 0's
``Mesh.stats["seconds"]`` over the window (``parallel/mesh.py``: every
collective across processes, the staging through pinned host memory and
the wait for the device's queued work included), over the window's outer
iterations.  A run of one process makes no collective and reads
nothing."""


def read(ctx):
    m = ctx.mesh
    iters = sum(s.iters for s in ctx.solves)
    if not m or not m["calls"] or not iters:
        return None
    return 1e3 * m["seconds"] / iters
