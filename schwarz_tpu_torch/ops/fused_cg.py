"""K3: the whole batched local CG in one launch, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/fused_cg.py`` ``fused_cg_solve`` (:84): batched
(Jacobi-)preconditioned CG on a pure-DIA operator with per-subdomain masked
freezing, the ``Combined(Iteration, ResidualNormReduction)`` stop, warm
start and a run-time ``max_iters``; it returns the same ``KrylovResult`` as
:func:`schwarz_tpu_torch.solvers.cg.cg_solve` (source: ``csrc/fused_cg.cu``).

The kernel runs one block per subdomain, each looping until its own
subdomain stops — exact, because the TPU kernel never changes a stopped
subdomain's state.  Vectors stay in device memory and the block reductions
are float32.  With S blocks on 132 SMs this first version is slow by design;
``PERF.md`` holds its time.

:func:`fused_cg_solve_plain` is the same function in plain PyTorch: the
batched CG of ``solvers/cg.py`` over the plain DIA product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv_plain
from schwarz_tpu_torch.solvers.cg import KrylovResult, cg_solve


def fused_cg_supported(
    n_subdomains: int, n_rows: int, n_diags: int, dtype,
    has_remainder: bool, precond_kind: str,
) -> bool:
    """The TPU gate (``schwarz_tpu/ops/fused_cg.py:44-62``) without its VMEM
    budget: that clause is the TPU's on-chip memory size, and the card keeps
    the vectors in device memory instead."""
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
) -> KrylovResult:
    """One-launch batched preconditioned CG; K3 on the card."""
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
    x = torch.empty_like(b)
    work = torch.empty((3, S, R), dtype=b.dtype, device=b.device)
    iters = torch.empty(S, dtype=torch.int32, device=b.device)
    rel = torch.empty(S, dtype=torch.float32, device=b.device)
    lib = cuda_build.library("fused_cg")
    cuda_build.check(
        lib.fused_cg_f32(
            dia_vals.data_ptr(), b.data_ptr(), x0.data_ptr(),
            dinv.data_ptr() if dinv is not None else None, x.data_ptr(),
            work[0].data_ptr(), work[1].data_ptr(), work[2].data_ptr(),
            iters.data_ptr(), rel.data_ptr(), S, K, R,
            cuda_build.int_array(offsets), float(tol) * float(tol),
            int(max_iters), cuda_build.stream_ptr(b.device)),
        "fused_cg_solve")
    fused_cg_solve.launches += 1
    return KrylovResult(x=x, iters=iters, rel_resnorm=rel)


fused_cg_solve.launches = 0
