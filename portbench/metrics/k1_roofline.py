"""K1's share of its roofline over the profiled stretch: the sum of each
launch's bound over the sum of K1's device time (kernels named
``dia_spmv_kernel`` and ``dia_spmv_chain_kernel``, ``csrc/dia_spmv.cu``).

A launch's bound comes from its operand, as the wrapper's counter keys it
(``dia_spmv.launches_by``: ``(offsets, dtype)`` for one product,
``("chain", offsets_in, offsets_out, dtype)`` for FSAI's ``G^T (G r)``),
and the plan's shapes: every K1 operand of the synchronous solver is
``(S, K, R_rows)``.  The count is a frozen copy of ``chip_smoke.py``'s
``k1_entry`` (:482-484) and ``chain_entry`` (:526-528): the diagonals, x
and y each read or written once, two operations a diagonal entry."""

from portbench.metrics.peaks import bound_s

ITEMSIZE = {"float32": 4, "float64": 8}


def launch(key, S: int, R: int):
    """``(bytes, operations, dtype)`` of one K1 launch of operand
    ``key``."""
    if key[0] == "chain":
        _, offs_in, offs_out, dtype = key
        K = len(offs_in) + len(offs_out)
    else:
        offs, dtype = key
        K = len(offs)
    return (S * K * R + 2 * S * R) * ITEMSIZE[dtype], 2 * K * S * R, dtype


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    by = p["counters"].get("dia_spmv", {}).get("launches_by", {})
    t = sum(s for name, (_, s) in p["kernels"].items() if "dia_spmv" in name)
    if not by or t <= 0:
        return None
    S, R = ctx.shapes["S"], ctx.shapes["R_rows"]
    bound = sum(n * bound_s(*launch(key, S, R)) for key, n in by.items())
    return 100 * bound / t
