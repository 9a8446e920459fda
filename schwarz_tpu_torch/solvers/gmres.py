"""Batched restarted GMRES local solver: the port of ``schwarz_tpu/solvers/
gmres.py``.

Replaces the reference's Ginkgo GMRES with restart (solve.cpp:486-570,
``non_symmetric_matrix``, restart = ``restart_iter``).  Left-preconditioned;
one restart cycle is an ``m``-step batched Arnoldi process with modified
Gram-Schmidt and a Givens QR of the Hessenberg matrix, whose rotated rhs
gives each subdomain's residual norm at every step, so a subdomain freezes
as soon as it meets its reduction criterion (Ginkgo's Combined criterion,
solve.cpp:469-478) or its total-iteration budget while the rest of the
batch continues.

The Krylov vectors live on the solver's device.  The Hessenberg column of
each step, (S, j + 2) numbers, comes to the host in one read; the rotations,
the stopping test and the back substitution run there in numpy, in the
vectors' dtype, with the JAX package's arithmetic.  The JAX loops run to
``m`` with masks because the TPU needs static shapes; these run over the
live range, and a cycle ends once no subdomain is active (the frozen state
does not change after that, so the result is the same).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from schwarz_tpu_torch.ops.spmv import ell_spmv_batched
from schwarz_tpu_torch.solvers.cg import KrylovResult, _dot


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def gmres_solve(
    vals: Optional[torch.Tensor],
    cols: Optional[torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float,
    max_iters: int,
    restart: int = 30,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    apply_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> KrylovResult:
    """Solve (generally non-symmetric) ``A_s x_s = b_s`` for every
    subdomain of the batch; left-preconditioned, restarted every
    ``restart`` iterations, at most ``max_iters`` iterations in all."""
    S, R = b.shape
    m = int(restart)
    max_iters = int(max_iters)
    if apply_fn is None:
        apply_fn = lambda x: ell_spmv_batched(vals, cols, x)  # noqa: E731
    M = precond if precond is not None else (lambda r: r)
    dt = _host(b[:0]).dtype
    tiny = torch.finfo(b.dtype).tiny
    tiny_h = dt.type(tiny)
    dev = b.device

    def pnorm(x):
        r = M(b - apply_fn(x))
        return torch.sqrt(_dot(r, r)), r

    rnorm0_d, _ = pnorm(x0)
    rnorm0 = _host(rnorm0_d)
    target = tol * rnorm0
    max_cycles = -(-max_iters // m)
    V = torch.empty((m + 1, S, R), dtype=b.dtype, device=dev)

    def arnoldi_cycle(x, inner):
        """One m-step cycle; returns (x_new, rnorm_new on the device)."""
        beta_d, r = pnorm(x)
        V[0] = r / torch.clamp(beta_d, min=tiny)[:, None]
        beta = _host(beta_d)
        Rm = np.zeros((S, m, m), dt)            # upper-triangular factor
        g = np.zeros((S, m + 1), dt)
        g[:, 0] = beta
        cs = np.zeros((S, m), dt)
        sn = np.zeros((S, m), dt)
        active = beta > target
        n_live = 0
        for j in range(m):
            if not active.any():
                break
            n_live = j + 1
            w = M(apply_fn(V[j]))
            hs = []
            # modified Gram-Schmidt against v_0 .. v_j
            for i in range(j + 1):
                hij = _dot(V[i], w)
                w = w - hij[:, None] * V[i]
                hs.append(hij)
            hnext = torch.sqrt(_dot(w, w))
            act_d = torch.from_numpy(active).to(dev)
            V[j + 1] = torch.where(
                act_d[:, None], w / torch.clamp(hnext, min=tiny)[:, None],
                torch.zeros_like(w))
            h = _host(torch.stack(hs + [hnext], dim=1))    # (S, j + 2)
            # the previous Givens rotations on the new column
            for i in range(j):
                hi, hip = h[:, i].copy(), h[:, i + 1].copy()
                h[:, i] = cs[:, i] * hi + sn[:, i] * hip
                h[:, i + 1] = -sn[:, i] * hi + cs[:, i] * hip
            hj, hj1 = h[:, j], h[:, j + 1]
            denom = np.sqrt(hj * hj + hj1 * hj1)
            c_new = np.where(denom > 0, hj / np.maximum(denom, tiny_h),
                             dt.type(1.0))
            s_new = np.where(denom > 0, hj1 / np.maximum(denom, tiny_h),
                             dt.type(0.0))
            cs[:, j] = np.where(active, c_new, cs[:, j])
            sn[:, j] = np.where(active, s_new, sn[:, j])
            col = np.zeros((S, m), dt)
            col[:, :j] = h[:, :j]
            col[:, j] = c_new * hj + s_new * hj1
            if j + 1 < m:
                col[:, j + 1] = hj1
            Rm[:, :, j] = np.where(active[:, None], col, Rm[:, :, j])
            gj = g[:, j].copy()
            g[:, j] = np.where(active, c_new * gj, g[:, j])
            g[:, j + 1] = np.where(active, -s_new * gj, g[:, j + 1])
            inner += active.astype(np.int32)
            # the total-iteration budget (Ginkgo's Combined criterion):
            # without it a subdomain could run to the end of its last
            # cycle, m - 1 iterations past max_iters
            active = (active & (np.abs(g[:, j + 1]) > target)
                      & (inner < max_iters))
        # back substitution on the triangular factor (a column that never
        # ran has a zero diagonal and gives 0)
        y = np.zeros((S, m), dt)
        for j in range(n_live - 1, -1, -1):
            s_ = g[:, j] - np.einsum("sk,sk->s", Rm[:, j, :n_live],
                                     y[:, :n_live])
            diag = Rm[:, j, j]
            y[:, j] = np.where(np.abs(diag) > 0,
                               s_ / np.where(diag == 0, dt.type(1.0), diag),
                               dt.type(0.0))
        if n_live:
            y_d = torch.from_numpy(y[:, :n_live]).to(dev)
            dx = torch.einsum("msr,sm->sr", V[:n_live], y_d)
        else:
            dx = torch.zeros_like(x)
        x_new = x + dx
        rnorm_new, _ = pnorm(x_new)
        return x_new, rnorm_new

    x = x0
    rnorm = rnorm0_d
    inner = np.zeros(S, np.int32)
    active = rnorm0 > np.maximum(target, dt.type(0.0))
    cycles = 0
    while active.any() and cycles < max_cycles:
        x_new, rnorm_new = arnoldi_cycle(x, inner)
        act_d = torch.from_numpy(active).to(dev)
        x = torch.where(act_d[:, None], x_new, x)
        rnorm = torch.where(act_d, rnorm_new, rnorm)
        active = active & (_host(rnorm) > target)
        cycles += 1
    rel = rnorm / torch.where(rnorm0_d > 0, rnorm0_d,
                              torch.ones_like(rnorm0_d))
    return KrylovResult(x=x, iters=torch.from_numpy(inner).to(dev),
                        rel_resnorm=rel)
