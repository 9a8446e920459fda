"""Free-running asynchronous RAS, 2-D block-grid tier: the port of
``schwarz_tpu/ops/async_ras_2d.py``.

Extends the 1-D tier (:mod:`.async_ras`, see there for the protocol) to
``px x py`` block grids of operators on the 9-point grid stencil
{0, +-1, +-n, +-n +- 1} of an n x n grid (``laplacian_2d``, upwind
advection, the anisotropic 9-point operator, variable coefficients).  Each
block holds its extended iterate (block + overlap + stencil ring) as a
(By, Bx) window and exchanges four boundary strips per round: left/right
edge columns and top/bottom edge rows.

Corners: strips are cut from the sender's extended window, so a left/right
strip carries the sender's top/bottom halo rows and an up/down strip its
left/right halo columns; diagonal-neighbour data arrives in two hops
(staleness <= 2B+1), inside the bounded-staleness hypothesis of the
asynchronous convergence theory.

The rank is the asynchronous unit.  ``num_ranks`` (default: one rank per
block) may be any D with a factorization (pdx, pdy) that tiles the block
grid; a rank then folds a (ply, plx) sub-grid of blocks into one tile,
refreshes the halos between its own windows fresh each round and sends
only the tile's edge strips through the message rings.  With one rank the
whole block solve runs in one thread block.

Scope, as in the JAX package: float32; the overlap is fixed by the halo
tile at (HX-1, HY-1) = (63, 7) grid cells, and ``HX``, ``HY`` and the
roundings of the block size define which cells a block owns, so they are
the JAX package's exactly.  The TPU's VMEM estimate for the folded tile is
not carried over (on the card the tile lives in device memory); in its place
K6's wrapper refuses a rank count the card cannot hold co-resident.

``mesh`` deals the ranks of the row-major rank grid to the processes of a
group, D / P consecutive ranks each, as :mod:`.async_ras` does for the 1-D
tier: each process keeps and launches its ranks, ``run`` gathers the
iterate and the aux lanes, and the checkpoints hold the whole state.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops.async_ras import _all_done, iterative_refinement_run
from schwarz_tpu_torch.parallel.mesh import (cut, gather, group_of,
                                             mesh_ranks, write_once)
from schwarz_tpu_torch.utils.backend import resolve_device
from schwarz_tpu_torch.ops.async_ras_2d_kernel import (  # noqa: F401
    HX,
    HY,
    LANES,
    async_ras_2d_rounds,
    async_ras_2d_rounds_plain,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class AsyncPlan2D:
    """Per-block extended-window stencil data (stacked over S = px*py)."""

    S: int
    px: int
    py: int
    n: int                  # grid side
    N: int                  # true global size (n*n)
    bx: int                 # owned block width  (multiple of 128)
    by: int                 # owned block height (multiple of 8)
    Bx: int                 # bx + 2*HX
    By: int                 # by + 2*HY
    coef: np.ndarray        # (S, 9, By, Bx) f32: C,E,W,S,N,SE,SW,NE,NW
    b: np.ndarray           # (S, By, Bx)
    dinv: np.ndarray        # (S, By, Bx)
    mask_dom: np.ndarray    # (S, By, Bx) local solve domain
    mask_int: np.ndarray    # (S, By, Bx) owned block
    boost: "np.ndarray | None" = None   # (S, By, Bx) O-RAS Robin diag term


def grid_stencil(mat):
    """The 2-D tier's structural gates: (n, rows_of, diffs) of an operator
    on the 9-point stencil of an n x n grid.  Raises NotImplementedFeature,
    as the JAX package's plan does, for a size that is no perfect square,
    offsets outside the stencil, and couplings that cross grid rows."""
    N = mat.n
    n = int(math.isqrt(N))
    if n * n != N:
        raise NotImplementedFeature(
            f"2-D free-running mode requires a square-grid operator; "
            f"size {N} is not a perfect square"
        )
    rows_of = np.repeat(np.arange(N, dtype=np.int64), np.diff(mat.row_ptrs))
    diffs = mat.col_idxs.astype(np.int64) - rows_of
    allowed = {0, 1, -1, n, -n, n - 1, n + 1, -(n - 1), -(n + 1)}
    offs = set(int(o) for o in np.unique(diffs))
    if not offs <= allowed:
        raise NotImplementedFeature(
            f"2-D free-running mode requires 9-point grid sparsity "
            f"(offsets within {{0, +-1, +-{n}, +-{n} +- 1}}); found offsets "
            f"{sorted(offs - allowed)[:5]} — use the 1-D kernel for banded "
            "operators or the staleness emulation"
        )
    # column drift check: a grid-stencil coupling moves at most one grid
    # column (catches +-1 wrapping across grid rows and degenerate n)
    gx_r = rows_of % n
    gx_c = mat.col_idxs % n
    if np.any(np.abs(gx_r - gx_c) > 1):
        raise NotImplementedFeature(
            "couplings cross grid rows: not a 2-D grid stencil"
        )
    return n, rows_of, diffs


def check_oras_weight(oras_weight: float) -> float:
    """The O-RAS Robin coefficient as a float; raises outside [-1, 0]."""
    c = float(oras_weight)
    if not -1.0 <= c <= 0.0:
        raise ValueError(
            f"oras_weight={c} outside [-1, 0]: the Robin coefficient "
            "must sit in (-1, 0] (0 = Dirichlet, -1 = Neumann limit)"
        )
    return c


def check_overlap(overlap: Optional[int]) -> None:
    """The tier's overlap is fixed by the halo tile; a larger request cannot
    be honoured and raises, so that the dispatch falls through to the 1-D
    banded tier, which honours any overlap.  A smaller request gets more
    overlap than asked, a valid RAS that converges at least as fast."""
    if overlap is not None and overlap > HY - 1:
        raise NotImplementedFeature(
            f"the 2-D free-running kernel provides a fixed "
            f"({HX - 1}, {HY - 1})-cell overlap; requested overlap "
            f"{overlap} exceeds it — the 1-D banded kernel honors "
            "arbitrary overlap"
        )


def _windows(g: np.ndarray, px: int, py: int, bx: int, by: int,
             out: np.ndarray) -> list:
    """Copy each block's extended window of the padded global grid ``g``
    (..., py*by, px*bx) into ``out`` (S, ..., By, Bx), zero outside the
    grid.  Returns each window's in-grid (row slice, column slice)."""
    nY, nX = py * by, px * bx
    inside = []
    for d in range(px * py):
        dyy, dxx = divmod(d, px)
        ys, xs = dyy * by - HY, dxx * bx - HX
        gy0, gy1 = max(ys, 0), min(ys + by + 2 * HY, nY)
        gx0, gx1 = max(xs, 0), min(xs + bx + 2 * HX, nX)
        ty, tx = slice(gy0 - ys, gy1 - ys), slice(gx0 - xs, gx1 - xs)
        out[d][..., ty, tx] = g[..., gy0:gy1, gx0:gx1]
        inside.append((ty, tx))
    return inside


def _window_rhs(rhs, n: int, px: int, py: int, bx: int,
                by: int) -> np.ndarray:
    """(S, By, Bx) f32 windows of the rhs on the padded grid."""
    bg = np.zeros((py * by, px * bx), np.float32)
    bg[:n, :n] = np.asarray(rhs, np.float32).reshape(n, n)
    b = np.zeros((px * py, by + 2 * HY, bx + 2 * HX), np.float32)
    _windows(bg, px, py, bx, by, b)
    return b


def build_async_plan_2d(
    mat, rhs, px: int, py: int, oras_weight: float = 0.0,
) -> AsyncPlan2D:
    """Extract the per-block 9-point stencil coefficient windows,
    bit-identical to the JAX package's plan.

    Raises NotImplementedFeature when the sparsity leaves the 9-point grid
    stencil.  ``oras_weight`` adds the O-RAS Robin diagonal on solve-domain
    boundary cells (preconditioner form, see ``build_async_plan``).
    """
    N = mat.n
    n, rows_of, diffs = grid_stencil(mat)

    # per-cell coefficient grids: C, E, W, S, N, SE, SW, NE, NW
    key = {0: 0, 1: 1, -1: 2, n: 3, -n: 4,
           n + 1: 5, n - 1: 6, -(n - 1): 7, -(n + 1): 8}
    bx = _round_up(_round_up(n, px) // px, 128)
    by = _round_up(_round_up(n, py) // py, 8)
    Bx, By = bx + 2 * HX, by + 2 * HY
    S = px * py

    # padded global grid (identity rows beyond n)
    cg = np.zeros((9, py * by, px * bx), np.float32)
    for off, k in key.items():
        m = diffs == off
        r = rows_of[m]
        cg[k, r // n, r % n] = mat.values[m]
    cg[0, :, n:] = 1.0
    cg[0, n:, :] = 1.0

    coef = np.zeros((S, 9, By, Bx), np.float32)
    dinv = np.ones((S, By, Bx), np.float32)
    mask_dom = np.zeros((S, By, Bx), np.float32)
    mask_int = np.zeros((S, By, Bx), np.float32)
    inside = _windows(cg, px, py, bx, by, coef)
    for d, (ty, tx) in enumerate(inside):
        # solve domain: everything but the outermost stencil ring, clipped
        # to the padded grid
        dom = np.zeros((By, Bx), np.float32)
        dom[1:By - 1, 1:Bx - 1] = 1.0
        grid = np.zeros((By, Bx), np.float32)
        grid[ty, tx] = 1.0
        mask_dom[d] = dom * grid
        mask_int[d, HY:HY + by, HX:HX + bx] = 1.0
        dg = coef[d, 0]
        dinv[d] = np.where(np.abs(dg) > 0, 1.0 / np.where(dg == 0, 1, dg),
                           1.0)
    coef *= mask_dom[:, None, :, :]

    boost = None
    if oras_weight:
        c = check_oras_weight(oras_weight)
        # displacement of each stencil entry k (grid rows, grid cols)
        disp = {1: (0, 1), 2: (0, -1), 3: (1, 0), 4: (-1, 0),
                5: (1, 1), 6: (1, -1), 7: (-1, 1), 8: (-1, -1)}
        boost = np.zeros((S, By, Bx), np.float32)
        for d in range(S):
            dom = mask_dom[d] > 0
            for k, (dy, dx) in disp.items():
                # target-in-domain mask: shift dom by (-dy, -dx) with zero
                # (out-of-window == dropped) fill
                tgt = np.zeros_like(dom)
                ys = slice(max(dy, 0), By + min(dy, 0))
                yt = slice(max(-dy, 0), By + min(-dy, 0))
                xs = slice(max(dx, 0), Bx + min(dx, 0))
                xt = slice(max(-dx, 0), Bx + min(-dx, 0))
                tgt[yt, xt] = dom[ys, xs]
                dropped = dom & ~tgt
                boost[d][dropped] += np.abs(coef[d, k][dropped])
        boost *= c
        dg = coef[:, 0] + boost
        dinv = np.where(np.abs(dg) > 0,
                        1.0 / np.where(dg == 0, 1, dg), 1.0).astype(np.float32)

    return AsyncPlan2D(
        S=S, px=px, py=py, n=n, N=N, bx=bx, by=by, Bx=Bx, By=By,
        coef=coef, b=_window_rhs(rhs, n, px, py, bx, by), dinv=dinv,
        mask_dom=mask_dom, mask_int=mask_int, boost=boost,
    )


def _device_grid(D: int, px: int, py: int) -> Optional[Tuple[int, int]]:
    """Factor ``D`` ranks into a (pdx, pdy) grid tiling the block grid.

    Returns the factorization whose per-rank (ply, plx) window sub-grid
    is most balanced, or None when no factorization divides (px, py).
    """
    best = None
    for pdx in range(1, D + 1):
        if D % pdx or px % pdx or py % (D // pdx):
            continue
        pdy = D // pdx
        score = abs(py // pdy - px // pdx)
        if best is None or score < best[0]:
            best = (score, pdx, pdy)
    return None if best is None else (best[1], best[2])


def rank_grid(D: int, px: int, py: int) -> Tuple[int, int]:
    """:func:`_device_grid`, raising the JAX package's ValueError when D
    ranks cannot tile the block grid."""
    grid = _device_grid(D, px, py)
    if grid is None:
        raise ValueError(
            f"mesh size {D} cannot tile the {px} x {py} block grid; "
            "pick a device count with a factorization dividing (px, py)"
        )
    return grid


class AsyncRASolver2D:
    """Host driver for the 2-D free-running kernel K6 (cf. AsyncRASolver).

    ``px x py`` is the block grid.  ``num_ranks`` may be smaller than the
    block count: each rank folds a (ply, plx) sub-grid of blocks into one
    tile (see the module docstring) and remains the asynchronous rank.
    Runs on the CUDA device unless ``device`` names another; on the CPU the
    kernel's plain version runs.
    """

    def __init__(self, mat, rhs, px: int, py: int,
                 tolerance: float = 1e-5, staleness: int = 1,
                 ninner: int = 16, chunk_rounds: int = 16,
                 num_ranks: Optional[int] = None, device=None,
                 fresh_read: bool = False, oras_weight: float = 0.0,
                 nonsym: bool = False, overlap: Optional[int] = None,
                 mesh=None):
        check_overlap(overlap)
        num_ranks, device = mesh_ranks(mesh, num_ranks, device)
        self.device = resolve_device(device)
        self.plan = build_async_plan_2d(mat, rhs, px, py,
                                        oras_weight=oras_weight)
        self.oras_weight = float(oras_weight)
        self.nonsym = bool(nonsym)
        self.mat = mat
        self.rhs = np.asarray(rhs)
        self.tolerance = tolerance
        self.staleness = staleness
        self.ninner = ninner
        self.chunk_rounds = chunk_rounds
        self.fresh_read = bool(fresh_read)
        S = px * py
        self.D = D = S if num_ranks is None else int(num_ranks)
        pdx, pdy = rank_grid(D, px, py)
        if D > LANES:
            raise ValueError(
                f"free-running mode keeps one gossip lane per rank: {D} "
                f"ranks exceed {LANES}; pass num_ranks, a count of at most "
                f"{LANES} that tiles the {px} x {py} block grid")
        self.pdx, self.pdy = pdx, pdy
        # the processes the ranks are dealt to (None: this process holds
        # all), and this process's ranks
        self._mesh = group_of(mesh)
        self.Dl = D if self._mesh is None else mesh.ranks_per_process
        self._ranks = (slice(0, D) if self._mesh is None
                       else self._mesh.block(D))
        ply, plx = py // pdy, px // pdx
        self.ply, self.plx = ply, plx
        # stacked-block permutation: position i holds global block
        # perm[i]; each rank's (ply, plx) windows contiguous, row-major
        perm = np.empty(S, np.int64)
        i = 0
        for Dy in range(pdy):
            for Dx in range(pdx):
                for iy in range(ply):
                    for ix in range(plx):
                        perm[i] = (Dy * ply + iy) * px + (Dx * plx + ix)
                        i += 1
        self._perm = perm
        p = self.plan
        self._dev = {k: self._fold(torch.from_numpy(getattr(p, k)[perm]))
                     for k in ("coef", "b", "dinv", "mask_dom", "mask_int")}
        if p.boost is not None:
            self._dev["boost"] = self._fold(torch.from_numpy(p.boost[perm]))

    def _fold(self, a: torch.Tensor) -> torch.Tensor:
        """(S, [9,] By, Bx) in stacked (perm) order -> the rank layout on
        the device, (D, [9,] FY, FX): each rank's windows side by side.
        Every block (a plan array) gives this process's ranks; this
        process's blocks (its state) give them too."""
        p, ply, plx = self.plan, self.ply, self.plx
        if a.shape[0] == p.S:
            a = a[self._ranks.start * ply * plx:self._ranks.stop * ply * plx]
        D = a.shape[0] // (ply * plx)
        mid = tuple(a.shape[1:-2])
        k = len(mid)
        a = a.reshape((D, ply, plx) + mid + (p.By, p.Bx))
        order = ((0,) + tuple(range(3, 3 + k))
                 + (1, 3 + k, 2, 4 + k))
        a = a.permute(order).reshape((D,) + mid + (ply * p.By, plx * p.Bx))
        return a.contiguous().to(self.device)

    def _unfold(self, a: torch.Tensor) -> torch.Tensor:
        """(D, FY, FX) -> (S, By, Bx) in stacked order (this process's
        ranks -> its blocks)."""
        p, ply, plx = self.plan, self.ply, self.plx
        a = a.reshape(-1, ply, p.By, plx, p.Bx).permute(0, 1, 3, 2, 4)
        return a.reshape(-1, p.By, p.Bx).contiguous()

    def set_rhs(self, rhs) -> None:
        """Repack the per-block RHS windows without rebuilding the plan
        (restarts of :func:`iterative_refinement_run` reuse the operator
        and masks)."""
        p = self.plan
        p.b = _window_rhs(rhs, p.n, p.px, p.py, p.bx, p.by)
        self.rhs = np.asarray(rhs)
        self._dev["b"] = self._fold(torch.from_numpy(p.b[self._perm]))

    def run_refined(self, tol: float = 1e-10, max_restarts: int = 12,
                    max_rounds: int = 400, resume_state=None,
                    checkpoint_path: Optional[str] = None,
                    coarse_q: int = 0, coarse_subdomains=None):
        """f64-accurate solve via iterative-refinement restarts of the
        f32 kernel (see :func:`iterative_refinement_run`)."""
        return iterative_refinement_run(
            self, tol=tol, max_restarts=max_restarts,
            max_rounds=max_rounds, resume_state=resume_state,
            checkpoint_path=checkpoint_path, coarse_q=coarse_q,
            coarse_subdomains=coarse_subdomains,
        )

    def save_checkpoint(self, state, path: str) -> None:
        """Persist a free-running state (X (S, By, Bx) with its halos,
        known, aux) in the JAX package's file format; across processes the
        blocks are gathered and process 0 writes the file."""
        leaves = [gather(self._mesh, a) for a in state]
        write_once(self._mesh, lambda: np.savez_compressed(path, *leaves))

    def load_checkpoint(self, path: str):
        """A state written by :meth:`save_checkpoint` (or by the JAX
        package), this process's block of it."""
        # np.savez_compressed appends .npz to a suffix-less path; accept
        # the same path back (save/load symmetry)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as data:
            leaves = [cut(self._mesh, np.ascontiguousarray(
                data[f"arr_{i}"], np.float32)) for i in range(3)]
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in leaves)

    def launch(self, x, known, aux, fn=async_ras_2d_rounds, **extra):
        """One launch: ``chunk_rounds`` rounds of all ranks on the folded
        iterate ``x`` (D, FY, FX).  ``fn`` is K6's wrapper or its plain
        version; ``extra`` goes to ``fn`` (K6's ``cluster=``)."""
        d = self._dev
        return fn(
            d["coef"], d["b"], d["dinv"], d["mask_dom"], d["mask_int"],
            x, known, aux, d.get("boost"),
            pdx=self.pdx, pdy=self.pdy, ply=self.ply, plx=self.plx,
            rounds=self.chunk_rounds, staleness=self.staleness,
            ninner=self.ninner, tol=self.tolerance,
            fresh_read=self.fresh_read, nonsym=self.nonsym, mesh=self._mesh,
            **extra,
        )

    def init_state(self):
        """Fresh (X, known, aux) on the device; X is (S, By, Bx) in stacked
        order, position i holding global block ``perm[i]`` (this process's
        blocks and ranks)."""
        p, D = self.plan, self.Dl
        X = torch.zeros((D * self.ply * self.plx, p.By, p.Bx),
                        dtype=torch.float32, device=self.device)
        known = torch.zeros((D, LANES), dtype=torch.float32,
                            device=self.device)
        aux = torch.full((D, LANES), -1.0, dtype=torch.float32,
                         device=self.device)
        aux[:, 2] = 0.0   # base round counter
        return X, known, aux

    def run(self, max_rounds: int = 400, resume_state=None,
            checkpoint_path: Optional[str] = None):
        """Iterate chunks until every rank detected convergence.

        Returns (x_global, info): x in the original row ordering (float32),
        info with per-rank detection rounds (``done_at``, unequal under
        asynchrony), rounds executed and the true relative residual."""
        p, S = self.plan, self.plan.S
        X, known, aux = (resume_state if resume_state is not None
                         else self.init_state())
        x = self._fold(X)
        t0 = time.perf_counter()
        rounds = 0
        while rounds < max_rounds:
            x, known, aux = self.launch(x, known, aux)
            rounds += self.chunk_rounds
            if _all_done(self._mesh, aux):
                break
        aux_h = gather(self._mesh, aux)
        elapsed = time.perf_counter() - t0
        X = self._unfold(x)
        if checkpoint_path is not None:
            self.save_checkpoint((X, known, aux), checkpoint_path)
        X_h = gather(self._mesh, X)
        sol_grid = np.zeros((p.py * p.by, p.px * p.bx), np.float32)
        for i in range(S):
            dyy, dxx = divmod(int(self._perm[i]), p.px)
            sol_grid[dyy * p.by:(dyy + 1) * p.by,
                     dxx * p.bx:(dxx + 1) * p.bx] = (
                X_h[i, HY:HY + p.by, HX:HX + p.bx]
            )
        sol = sol_grid[:p.n, :p.n].reshape(-1)
        res = self.rhs - self.mat.to_scipy() @ sol
        rel = float(np.linalg.norm(res) / max(np.linalg.norm(self.rhs),
                                              1e-300))
        done = aux_h[:, 1].astype(int)
        return sol, {
            "done_at": done,
            "converged": bool(np.all(done >= 0)),
            "rounds": rounds,
            "relative_residual_norm": rel,
            "time_s": elapsed,
            "grid": (p.py, p.px),
            "device_grid": (self.pdy, self.pdx),
            "fresh_read_hits": int(np.maximum(aux_h[:, 4], 0.0).sum()),
        }
