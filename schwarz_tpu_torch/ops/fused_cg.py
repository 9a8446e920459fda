"""K3: the whole batched local CG in one launch, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/fused_cg.py`` ``fused_cg_solve`` (:84): batched
(Jacobi-)preconditioned CG on a pure-DIA operator with per-subdomain masked
freezing, the ``Combined(Iteration, ResidualNormReduction)`` stop, warm
start and a run-time ``max_iters``; it returns the same ``KrylovResult`` as
:func:`schwarz_tpu_torch.solvers.cg.cg_solve` (source: ``csrc/fused_cg.cu``).

A subdomain runs on a thread-block cluster of C blocks, each block owning a
contiguous chunk of its rows, and loops until its own subdomain stops:
exact, because the TPU kernel never changes a stopped subdomain's state.  C
is the largest size for which the card holds all S clusters at once (one
wave).  When a block's chunk of x, r, p and A p fits its shared memory
(dinv too, if there is room), the vectors stay there for the whole solve
and the product reads other blocks' rows of p through distributed shared
memory (the 'shared' variant); otherwise the same kernel keeps them in
device memory (the 'global' variant).  Reductions are float64 partials of float32 products,
summed over the cluster in block order.  The bound is the solve's float32
operations; ``PERF.md`` holds the time.

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
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv_plain
from schwarz_tpu_torch.solvers.cg import KrylovResult, cg_solve

_max_clusters: dict = {}   # (device, K, C, smem) -> clusters the card holds


def fused_cg_supported(
    n_subdomains: int, n_rows: int, n_diags: int, dtype,
    has_remainder: bool, precond_kind: str,
) -> bool:
    """The TPU gate (``schwarz_tpu/ops/fused_cg.py:44-62``) without its VMEM
    budget: that clause is the TPU's on-chip memory size; the card keeps a
    subdomain's vectors in its cluster's shared memory when they fit, and
    in device memory when they do not."""
    del n_subdomains
    if dtype != torch.float32:
        return False
    if has_remainder or n_rows % 128 != 0 or n_diags == 0:
        return False
    return precond_kind in ("none", "jacobi")


def fused_cg_solve_plain(
    offsets: Tuple[int, ...],
    dia_vals: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    dinv: Optional[torch.Tensor],
    tol: float,
    max_iters: int,
) -> KrylovResult:
    precond = (lambda r: dinv * r) if dinv is not None else None
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
) -> KrylovResult:
    """One-launch batched preconditioned CG; K3 on the card.

    ``cluster`` forces the blocks per subdomain (the solver never does; the
    tests and the smoke run compare sizes).  The C and the variant of the
    last launch are kept in ``fused_cg_solve.cluster`` and
    ``fused_cg_solve.variant``.  Raises for a C the card cannot hold one
    cluster of."""
    if b.device.type == "cpu":
        return fused_cg_solve_plain(offsets, dia_vals, b, x0, dinv, tol,
                                    max_iters)
    S, K, R = dia_vals.shape
    ops = dict(dia_vals=dia_vals, b=b, x0=x0)
    if dinv is not None:
        ops["dinv"] = dinv
    cuda_build.check_operands("fused_cg_solve", (torch.float32,), **ops)
    if (b.shape != (S, R) or x0.shape != (S, R)
            or (dinv is not None and dinv.shape != (S, R))):
        raise ValueError(f"fused_cg_solve: vectors must be (S={S}, R={R})")
    if len(offsets) != K or not 0 < K <= 32:
        raise ValueError(
            f"fused_cg_solve: {len(offsets)} offsets for {K} diagonals")
    jacobi = dinv is not None
    lib = cuda_build.library("fused_cg")

    def geometry(c: int):
        chunk, _ = split_rows(R, c, 32)
        shared = fused_cg_variant(R, c, jacobi) == "shared"
        return chunk, fused_cg_smem_bytes(R, c, jacobi) if shared else 0

    def fits(c: int) -> int:
        key = (b.device, K, c, geometry(c)[1])
        if key not in _max_clusters:
            with torch.cuda.device(b.device):
                _max_clusters[key] = lib.fused_cg_max_clusters(K, c, key[3])
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
    work = (None,) * 3
    if not smem:
        work = torch.empty((3, S, R), dtype=b.dtype, device=b.device)
    cuda_build.check(
        lib.fused_cg_f32(
            dia_vals.data_ptr(), b.data_ptr(), x0.data_ptr(),
            dinv.data_ptr() if dinv is not None else None, x.data_ptr(),
            *(w.data_ptr() if w is not None else None for w in work),
            iters.data_ptr(), rel.data_ptr(), S, K, R,
            cuda_build.int_array(offsets), float(tol) * float(tol),
            int(max_iters), C, chunk, smem, cuda_build.stream_ptr(b.device)),
        "fused_cg_solve")
    fused_cg_solve.launches += 1
    fused_cg_solve.cluster = C
    fused_cg_solve.variant = "shared" if smem else "global"
    return KrylovResult(x=x, iters=iters, rel_resnorm=rel)


fused_cg_solve.launches = 0
fused_cg_solve.cluster = None   # blocks per subdomain of the last launch
fused_cg_solve.variant = None   # 'shared' or 'global'
