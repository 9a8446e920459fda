"""Flexible GMRES over all subdomains: the port of ``schwarz_tpu/solvers/
global_krylov.py``.

Krylov acceleration of the Schwarz method: instead of iterating the RAS
fixed point (the reference's only mode), solve the global system with
FGMRES preconditioned by one RAS application (local solves plus the optional
coarse correction).  The flexible variant tolerates the inexact RAS
preconditioner.

Vectors are in the interior layout (S, R_int) on the solver's device;
every subdomain lives there, so a global inner product is one sum over all
of them (the JAX package's ``psum`` over its mesh).  Across processes each
holds its block of subdomains, and the caller's ``psum`` adds the
processes' sums; the Hessenberg problem is then the same on every
process.  The small Hessenberg
least-squares problem (Givens rotations, stopping test, back substitution)
runs on the host in numpy, in the vectors' dtype: one read of the new
Hessenberg column per iteration.  The JAX loops run to ``restart`` with
masks for the TPU's static shapes; these run over the live range, and a
cycle ends at the first inactive step (every later step is masked out in
the JAX package, so the result is the same).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from schwarz_tpu_torch.utils.timing import HOST_READS, count, span, spanned


class FGMRESResult(NamedTuple):
    x: torch.Tensor         # (S, R_int)
    iters: int              # total Krylov iterations
    rel_resnorm: float      # final ||r|| / ||b||
    hist: np.ndarray        # (max_iters + 2,) residual-norm history
    state: tuple            # resumable cycle carry (x, rnorm, it, cycles,
                            # active, hist): chunked runs and checkpoints


def _gdot(a: torch.Tensor, b: torch.Tensor, psum=None) -> torch.Tensor:
    d = torch.sum(a * b)
    return d if psum is None else psum(d)


def fgmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float,
    max_iters: int,
    restart: int,
    state: Optional[tuple] = None,
    cycle_budget: Optional[int] = None,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> FGMRESResult:
    """Right-preconditioned flexible GMRES(restart).

    ``state`` (a prior result's ``.state``) resumes at a restart boundary;
    ``cycle_budget`` caps the restart cycles run in this call.  A chunked
    run gives the unchunked run's result, because FGMRES(restart) drops its
    Krylov basis at every restart anyway.

    The carry is ``(x, rnorm, it_total, cycles, active, hist)``: ``x`` a
    device tensor, ``rnorm`` a numpy scalar of the vectors' dtype,
    ``it_total`` and ``cycles`` numpy int32, ``active`` a numpy bool and
    ``hist`` a host array.  ``psum`` (``Mesh.psum``) completes each inner
    product across processes.
    """
    m = int(restart)
    dt = b.detach()[:0].cpu().numpy().dtype
    tiny = dt.type(torch.finfo(b.dtype).tiny)
    one, zero = dt.type(1.0), dt.type(0.0)

    def host(t, site):
        count(HOST_READS, site)
        return t.detach().cpu().numpy()

    bnorm = np.sqrt(host(_gdot(b, b, psum), "fgmres.norm"))
    target = tol * np.maximum(bnorm, tiny)
    max_cycles = -(-max_iters // m)

    @spanned("fgmres.cycle")
    def cycle(carry):
        x, rnorm, it_total, cycles, active, hist = carry
        r = b - matvec(x)
        beta_d = torch.sqrt(_gdot(r, r, psum))
        V = [r / torch.clamp(beta_d, min=float(tiny))]
        beta = host(beta_d, "fgmres.norm")
        Z = []
        Rm = np.zeros((m, m), dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta
        cs = np.zeros(m, dt)
        sn = np.zeros(m, dt)
        act = bool(active) and bool(beta > target)
        for j in range(m):
            if not act:
                break
            z = precond(V[j])
            w = matvec(z)
            Z.append(z)
            with span("fgmres.orthogonalize"):
                hs = []
                # modified Gram-Schmidt against v_0 .. v_j
                for i in range(j + 1):
                    hij = _gdot(V[i], w, psum)
                    w = w - hij * V[i]
                    hs.append(hij)
                hnext_d = torch.sqrt(_gdot(w, w, psum))
                V.append(w / torch.clamp(hnext_d, min=float(tiny)))
                h = np.zeros(m + 1, dt)
                h[:j + 2] = host(torch.stack(hs + [hnext_d]), "fgmres.column")
                for i in range(j):
                    hi, hip = h[i], h[i + 1]
                    h[i] = cs[i] * hi + sn[i] * hip
                    h[i + 1] = -sn[i] * hi + cs[i] * hip
                hj, hj1 = h[j], h[j + 1]
                den = np.sqrt(hj * hj + hj1 * hj1)
                c_new = hj / np.maximum(den, tiny) if den > 0 else one
                s_new = hj1 / np.maximum(den, tiny) if den > 0 else zero
                cs[j], sn[j] = c_new, s_new
                h[j] = c_new * hj + s_new * hj1
                Rm[:, j] = h[:m]
                gj = g[j]
                g[j] = c_new * gj
                g[j + 1] = -s_new * gj
            it_total = it_total + np.int32(1)
            hist[it_total] = np.abs(g[j + 1])
            act = bool(np.abs(g[j + 1]) > target) and it_total < max_iters
        # back substitution over the columns that ran
        n = len(Z)
        y = np.zeros(m, dt)
        for j in range(n - 1, -1, -1):
            s_ = g[j] - Rm[j, :n] @ y[:n]
            diag = Rm[j, j]
            y[j] = s_ / diag if abs(diag) > 0 else zero
        if n:
            yd = torch.from_numpy(y[:n]).to(b.device)
            x = x + torch.einsum("m,msr->sr", yd, torch.stack(Z))
        r2 = b - matvec(x)
        rnorm = np.sqrt(host(_gdot(r2, r2, psum), "fgmres.norm"))
        active = np.bool_(bool(rnorm > target) and it_total < max_iters)
        return x, rnorm, it_total, cycles + np.int32(1), active, hist

    if state is None:
        r0 = b - matvec(x0)
        rnorm0 = np.sqrt(host(_gdot(r0, r0, psum), "fgmres.norm"))
        hist0 = np.zeros(max_iters + 2, dt)
        hist0[0] = rnorm0
        carry = (x0, rnorm0, np.int32(0), np.int32(0),
                 np.bool_(rnorm0 > target), hist0)
    else:
        x_s, rn_s, it_s, cy_s, _, h_s = state
        rn_s = np.asarray(rn_s, dt)[()]
        it_s, cy_s = np.int32(it_s), np.int32(cy_s)
        h_s = np.asarray(h_s, dt).copy()
        # activity under THIS call's tolerance and budget; a resumed solve
        # may carry a larger max_iters than the run that checkpointed, and
        # then its history grows
        if h_s.shape[0] < max_iters + 2:
            h2 = np.zeros(max_iters + 2, dt)
            h2[:h_s.shape[0]] = h_s
            h_s = h2
        carry = (x_s, rn_s, it_s, cy_s,
                 np.bool_(rn_s > target and it_s < max_iters), h_s)
    cycle_stop = (max_cycles if cycle_budget is None
                  else min(max_cycles, int(carry[3]) + int(cycle_budget)))
    while carry[4] and carry[3] < cycle_stop:
        carry = cycle(carry)
    x, rnorm, iters, _, _, hist = carry
    return FGMRESResult(x=x, iters=int(iters),
                        rel_resnorm=float(rnorm / np.maximum(bnorm, tiny)),
                        hist=hist, state=carry)
