"""The direct locals' product with the explicit inverse
(``solvers/direct.py`` ``inverse_apply``: one batched product, ``aten::
bmm``) against its roofline over the profiled stretch: the inverse (S, R,
R) read once and the vectors (S, R) read and written once at 3.35 TB/s,
as ``chip_smoke.py`` bounds it (:2290-2291), over the device time of the
kernels the profiler attributes to ``aten::bmm``."""

from portbench.metrics.peaks import bound_s

ITEMSIZE = {"float32": 4, "float64": 8}


def apply_bytes(S: int, R: int, itemsize: int) -> int:
    return (S * R * R + 2 * S * R) * itemsize


def read(ctx):
    p, sh = ctx.profile, ctx.shapes
    if p is None or not sh.get("inverse"):
        return None
    n, t = p["ops"].get("aten::bmm", (0, 0.0))
    if not n or t <= 0:
        return None
    S, R, _ = sh["inverse"]
    dtype = sh["inverse_dtype"]
    bound = bound_s(apply_bytes(S, R, ITEMSIZE[dtype]), 2 * S * R * R, dtype)
    return 100 * n * bound / t
