"""K3: the whole batched local CG in one launch, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/fused_cg.py`` ``fused_cg_solve`` (:84): batched
preconditioned CG on a pure-DIA operator with per-subdomain masked
freezing, the ``Combined(Iteration, ResidualNormReduction)`` stop, warm
start and a run-time ``max_iters``; it returns the same ``KrylovResult`` as
:func:`schwarz_tpu_torch.solvers.cg.cg_solve` (source: ``csrc/fused_cg.cu``).
The preconditioner is none, Jacobi (``dinv``) or FSAI(0) (``fsai``: the
banded factors G and G^T, ``M^-1 r = G^T (G r)``); the JAX kernel refuses
FSAI, so that mode is held to its plain version only.

A subdomain runs on a thread-block cluster of C blocks, each block owning a
contiguous chunk of its rows, and loops until its own subdomain stops:
exact, because the TPU kernel never changes a stopped subdomain's state.  C
is the largest size for which the card holds all S clusters at once (one
wave).  When a block's chunk of x, r, p and A p (FSAI's w too) fits its
shared memory (dinv, or FSAI's planes of A, G and G^T, too, if there is
room), the vectors stay there for the whole solve and the products read
other blocks' rows of p (FSAI's r and w too) through distributed shared
memory (the 'shared' variant); otherwise the same kernel keeps them in
device memory (the 'global' variant).  Reductions are float64 partials of
float32 products, summed over the cluster in block order.  The bound is
the solve's float32 operations; ``PERF.md`` holds the time.

:func:`fused_cg_solve_plain` is the same function in plain PyTorch: the
batched CG of ``solvers/cg.py`` over the plain DIA product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.cluster_geometry import (ANY_CLUSTER_SIZES,
                                                    choose_cluster,
                                                    fused_cg_smem_bytes,
                                                    fused_cg_variant,
                                                    require_cluster,
                                                    split_rows)
from schwarz_tpu_torch.ops.dia_kernel import (dia_spmv_chain_plain,
                                              dia_spmv_plain)
from schwarz_tpu_torch.solvers.cg import KrylovResult, cg_solve

_max_clusters: dict = {}   # (device, K, C, smem, fsai) -> clusters it holds


def fused_cg_supported(
    n_subdomains: int, n_rows: int, n_diags: int, dtype,
    has_remainder: bool, precond_kind: str, factors_dia: bool = False,
) -> bool:
    """The TPU gate (``schwarz_tpu/ops/fused_cg.py:44-62``) without its VMEM
    budget: that clause is the TPU's on-chip memory size; the card keeps a
    subdomain's vectors in its cluster's shared memory when they fit, and
    in device memory when they do not.  Beyond the TPU gate, FSAI passes
    when its factors are banded (``factors_dia``)."""
    del n_subdomains
    if dtype != torch.float32:
        return False
    if has_remainder or n_rows % 128 != 0 or n_diags == 0:
        return False
    return precond_kind in ("none", "jacobi") or (
        precond_kind == "fsai" and factors_dia)


def _mode(dinv, fsai) -> str:
    if dinv is not None and fsai is not None:
        raise ValueError("fused_cg_solve: Jacobi and FSAI at once")
    return "fsai" if fsai is not None else (
        "jacobi" if dinv is not None else "none")


def fused_cg_solve_plain(
    offsets: Tuple[int, ...],
    dia_vals: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    dinv: Optional[torch.Tensor],
    tol: float,
    max_iters: int,
    fsai: Optional[tuple] = None,
) -> KrylovResult:
    mode = _mode(dinv, fsai)
    precond = None
    if mode == "jacobi":
        precond = lambda r: dinv * r  # noqa: E731
    elif mode == "fsai":
        go, gd, uo, ud = fsai
        precond = lambda r: dia_spmv_chain_plain(go, gd, uo, ud, r)  # noqa
    return cg_solve(None, None, b, x0, tol, max_iters, precond=precond,
                    apply_fn=lambda v: dia_spmv_plain(offsets, dia_vals, v))


def fused_cg_solve(
    offsets: Tuple[int, ...],
    dia_vals: torch.Tensor,        # (S, K, R) float32
    b: torch.Tensor,               # (S, R) float32
    x0: torch.Tensor,              # (S, R) float32
    dinv: Optional[torch.Tensor],  # (S, R) Jacobi inverse diagonal, or None
    tol: float,
    max_iters: int,
    cluster: Optional[int] = None,
    fsai: Optional[tuple] = None,  # (offsets G, G (S, Kg, R), offsets G^T,
                                   #  G^T (S, Ku, R)), or None
) -> KrylovResult:
    """One-launch batched preconditioned CG; K3 on the card.

    ``cluster`` forces the blocks per subdomain (the solver never does; the
    tests and the smoke run compare sizes).  The C and the variant of the
    last launch are kept in ``fused_cg_solve.cluster`` and
    ``fused_cg_solve.variant``, the launches by preconditioner ('none',
    'jacobi', 'fsai') in ``fused_cg_solve.launches_by``.  Raises for a C
    the card cannot hold one cluster of."""
    mode = _mode(dinv, fsai)
    if b.device.type == "cpu":
        return fused_cg_solve_plain(offsets, dia_vals, b, x0, dinv, tol,
                                    max_iters, fsai)
    S, K, R = dia_vals.shape
    ops = dict(dia_vals=dia_vals, b=b, x0=x0)
    if dinv is not None:
        ops["dinv"] = dinv
    go, gd, uo, ud = fsai if fsai is not None else ((), None, (), None)
    if fsai is not None:
        ops.update(g=gd, gt=ud)
    cuda_build.check_operands("fused_cg_solve", (torch.float32,), **ops)
    if (b.shape != (S, R) or x0.shape != (S, R)
            or (dinv is not None and dinv.shape != (S, R))):
        raise ValueError(f"fused_cg_solve: vectors must be (S={S}, R={R})")
    if len(offsets) != K or not 0 < K <= 32:
        raise ValueError(
            f"fused_cg_solve: {len(offsets)} offsets for {K} diagonals")
    for what, o, dia in (("G", go, gd), ("G^T", uo, ud)):
        if dia is not None and (dia.dim() != 3 or dia.shape[0::2] != (S, R)
                                or len(o) != dia.shape[1]
                                or not 0 < len(o) <= 32):
            raise ValueError(
                f"fused_cg_solve: {what} {tuple(dia.shape)} with {len(o)} "
                f"offsets (S={S}, R={R}, at most 32 diagonals)")
    planes = K + len(go) + len(uo)
    lib = cuda_build.library("fused_cg")

    def geometry(c: int):
        chunk, _ = split_rows(R, c, 32)
        shared = fused_cg_variant(R, c, mode) == "shared"
        return chunk, (fused_cg_smem_bytes(R, c, mode, planes) if shared
                       else 0)

    def fits(c: int) -> int:
        key = (b.device, K, c, geometry(c)[1], mode == "fsai")
        if key not in _max_clusters:
            with torch.cuda.device(b.device):
                _max_clusters[key] = lib.fused_cg_max_clusters(
                    K, c, key[3], int(key[4]))
        return _max_clusters[key]

    if cluster is None:
        # more subdomains than one wave of single blocks: several waves
        C = choose_cluster(S, fits, ANY_CLUSTER_SIZES) or 1
    else:
        C = int(cluster)
    require_cluster("fused_cg_solve", S, C, fits, ANY_CLUSTER_SIZES, need=1,
                    unit="subdomain")
    chunk, smem = geometry(C)
    x = torch.empty_like(b)
    iters = torch.empty(S, dtype=torch.int32, device=b.device)
    rel = torch.empty(S, dtype=torch.float32, device=b.device)
    # r, p, A p and FSAI's w of the global-memory variant
    work = ((None,) * 4 if smem else
            tuple(torch.empty((4, S, R), dtype=b.dtype, device=b.device)))
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    cuda_build.check(
        lib.fused_cg_f32(
            dia_vals.data_ptr(), ptr(gd), ptr(ud), b.data_ptr(),
            x0.data_ptr(), ptr(dinv), x.data_ptr(), *(ptr(w) for w in work),
            iters.data_ptr(), rel.data_ptr(), S, K, len(go), len(uo), R,
            cuda_build.int_array(offsets), cuda_build.int_array(go),
            cuda_build.int_array(uo), float(tol) * float(tol),
            int(max_iters), C, chunk, smem, cuda_build.stream_ptr(b.device)),
        "fused_cg_solve")
    fused_cg_solve.launches += 1
    fused_cg_solve.launches_by[mode] = (
        fused_cg_solve.launches_by.get(mode, 0) + 1)
    fused_cg_solve.cluster = C
    fused_cg_solve.variant = "shared" if smem else "global"
    return KrylovResult(x=x, iters=iters, rel_resnorm=rel)


fused_cg_solve.launches = 0
fused_cg_solve.launches_by = {}   # preconditioner ('none', 'jacobi', 'fsai')
fused_cg_solve.cluster = None   # blocks per subdomain of the last launch
fused_cg_solve.variant = None   # 'shared' or 'global'
