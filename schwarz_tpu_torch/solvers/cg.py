"""Batched conjugate-gradient local solver.

Port of ``schwarz_tpu/solvers/cg.py``: one loop over all subdomains at once,
subdomains that have met their criterion frozen by masking, and Ginkgo's
``Combined(Iteration, ResidualNormReduction)`` stop (``max_iters``, or
``||r|| / ||r0|| <= tol`` with ``r0`` the initial residual of this solve).
The loop runs on the host; its condition reads one flag from the device per
iteration (``host_reads`` site ``cg.active``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from schwarz_tpu_torch.ops.spmv import ell_spmv_batched
from schwarz_tpu_torch.utils.timing import HOST_READS, count


class KrylovResult(NamedTuple):
    x: torch.Tensor            # (S, R) solution
    iters: torch.Tensor        # (S,) int32 iterations taken per subdomain
    rel_resnorm: torch.Tensor  # (S,) final ||r||/||r0|| (recurrence residual)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _any(active: torch.Tensor) -> bool:
    count(HOST_READS, "cg.active")
    return bool(active.any())


def cg_solve(
    vals: Optional[torch.Tensor],
    cols: Optional[torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float,
    max_iters: int,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    apply_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> KrylovResult:
    """Solve ``A_s x_s = b_s`` for every subdomain ``s`` of the batch.

    vals/cols: (S, R, W) padded ELL; b, x0: (S, R).  ``apply_fn`` overrides
    the operator application (e.g. the DIA formulation).
    """
    if apply_fn is None:
        apply_fn = lambda x: ell_spmv_batched(vals, cols, x)  # noqa: E731
    M = precond if precond is not None else (lambda r: r)
    eps = torch.finfo(b.dtype).tiny

    x = x0
    r = b - apply_fn(x0)
    z = M(r)
    p = z
    rho = _dot(r, z)
    rnorm0_sq = _dot(r, r)
    rnorm_sq = rnorm0_sq
    tol2 = (tol * tol) * rnorm0_sq
    active = (rnorm0_sq > tol2) & (rnorm0_sq > 0)
    iters = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    it = 0
    while it < max_iters and _any(active):
        Ap = apply_fn(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp > 0, rho / torch.clamp(pAp, min=eps),
                            torch.zeros_like(pAp))
        a = torch.where(active, alpha, torch.zeros_like(alpha))[:, None]
        x = x + a * p
        r = r - a * Ap
        z = M(r)
        rho_new = _dot(r, z)
        beta = torch.where(rho > 0, rho_new / torch.clamp(rho, min=eps),
                           torch.zeros_like(rho))
        p = torch.where(active[:, None], z + beta[:, None] * p, p)
        rnorm_sq = torch.where(active, _dot(r, r), rnorm_sq)
        rho = torch.where(active, rho_new, rho)
        iters = iters + active.to(torch.int32)
        active = active & (rnorm_sq > tol2)
        it += 1
    rel = torch.sqrt(rnorm_sq / torch.where(rnorm0_sq > 0, rnorm0_sq,
                                            torch.ones_like(rnorm0_sq)))
    return KrylovResult(x=x, iters=iters, rel_resnorm=rel)
