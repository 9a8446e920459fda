"""Free-running asynchronous RAS, 1-D banded tier: the port of
``schwarz_tpu/ops/async_ras.py``.

The reference's research core: each rank loops {exchange -> update ->
solve} at its own pace on one-sided halo data, with decentralized
convergence detection.  One launch of K5 (:mod:`.async_ras_kernel`) runs
``chunk_rounds`` barrier-free rounds on every rank; the host relaunches
until every rank reports detection, the only global synchronisation.

The rank is the asynchronous unit.  ``num_ranks`` (default: one rank per
subdomain, as the reference runs one MPI rank per subdomain) may be a
divisor D of S; each rank then folds Sl = S/D consecutive windows into one
vector and updates them together, reading halos between its own windows
fresh and only its two edge strips through the message rings.

Scope, as in the JAX package: banded operators (at most ``MAX_DIAGS``
diagonals), regular 1-D strips, float32 compute.  The TPU's VMEM budget
gate and its DMA-semaphore unit (``dma_sem_unit_bytes``) are not carried
over: on the card the vectors live in device memory, and a message's
arrival is a sequence number, not a DMA count.  ``fresh_read`` needs the
flag-order probe (K9, :mod:`schwarz_tpu_torch.diagnostics`) to have passed
on the card in the process.

``mesh`` (:class:`~schwarz_tpu_torch.parallel.mesh.Mesh`) deals the ranks
to the processes of a group, D / P consecutive ranks each, as the JAX
package's ``shard_map`` over a multi-controller mesh does: each process
keeps its ranks' plan arrays and state and launches K5 for them, the
neighbours' rings reached through the mesh's window.  The chunk loop's exit
is one gathered decision a chunk; ``run`` gathers the iterate and the aux
lanes, so every process returns the same ``(x, info)``, and the
checkpoints hold the whole state in the JAX package's file layout, written
by process 0 and cut to each process's block when read.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.parallel.mesh import (cut, gather, group_of,
                                             mesh_ranks, write_once)
from schwarz_tpu_torch.utils.backend import resolve_device
from schwarz_tpu_torch.ops.async_ras_kernel import (  # noqa: F401
    LANES,
    async_ras_rounds,
    async_ras_rounds_plain,
    solver_kind,
)

MAX_DIAGS = 16

# relative tolerance the f32 kernels can reliably detect in-band; below
# this, drivers switch to iterative_refinement_run (f64 restarts)
F32_TOL_FLOOR = 1e-5


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class AsyncPlan:
    """Host-side static data for the free-running kernel (stacked over S)."""

    S: int
    N: int                  # true global size
    R: int                  # padded interior rows per subdomain (R % 128 == 0)
    hw: int                 # halo strip width (hw % 128 == 0, >= ovp + bw)
    ovp: int                # effective overlap (>= requested; ovp % 64 == 0)
    total: int              # R + 2*hw
    offsets: Tuple[int, ...]   # DIA offsets in TOTAL (= global) row space
    dia: np.ndarray         # (S, K, total) f32 — extended-domain rows of A
    b: np.ndarray           # (S, total) f32
    dinv: np.ndarray        # (S, total) f32 Jacobi inverse diagonal
    mask_dom: np.ndarray    # (S, total) f32 — local solve domain
    mask_int: np.ndarray    # (S, total) f32 — owned interior rows
    boost: "np.ndarray | None" = None   # (S, total) f32 O-RAS Robin diag term


def _window_rhs(rhs, S: int, R: int, hw: int, N: int) -> np.ndarray:
    """(S, total) f32 windows of the rhs on the padded row space."""
    total = R + 2 * hw
    gb = np.zeros(S * R, np.float32)
    gb[:N] = np.asarray(rhs, np.float32)
    b = np.zeros((S, total), dtype=np.float32)
    for d in range(S):
        lo = d * R - hw
        g0, g1 = max(lo, 0), min(lo + total, S * R)
        b[d, g0 - lo:g1 - lo] = gb[g0:g1]
    return b


def plan_geometry(mat, S: int, overlap: int):
    """The 1-D tier's gates and window geometry: (rows_of, diffs, offsets,
    R, ovp, hw).  Raises NotImplementedFeature, as the JAX package's plan
    does, for more than ``MAX_DIAGS`` diagonals, a halo strip wider than
    the interior, or a missing main diagonal."""
    N = mat.n
    rows_of = np.repeat(np.arange(N, dtype=np.int64), np.diff(mat.row_ptrs))
    diffs = mat.col_idxs.astype(np.int64) - rows_of
    offs = np.unique(diffs)
    if len(offs) > MAX_DIAGS:
        raise NotImplementedFeature(
            f"free-running async kernel requires a banded operator with at "
            f"most {MAX_DIAGS} diagonals; this matrix has {len(offs)} "
            "distinct (col - row) offsets — use the bounded-staleness "
            "emulation (comm.onesided + staleness) for unstructured matrices"
        )
    offsets = tuple(int(o) for o in offs)
    bw = max(abs(o) for o in offsets) if offsets else 1
    R = _round_up(_round_up(N, S) // S, 128)
    # the requested overlap counts BFS levels; one level of a banded
    # operator reaches ``bw`` flattened rows
    ovp = _round_up(max(overlap, 1) * bw, 64)
    hw = _round_up(ovp + bw, 128)
    if hw > R:
        raise NotImplementedFeature(
            f"halo strip ({hw}) exceeds the per-device interior ({R}): "
            "bandwidth/overlap too large for this many subdomains"
        )
    if 0 not in offsets:
        raise NotImplementedFeature(
            "async kernel requires a nonzero main diagonal"
        )
    return rows_of, diffs, offsets, R, ovp, hw


def build_async_plan(mat, rhs, num_subdomains: int, overlap: int,
                     oras_weight: float = 0.0) -> AsyncPlan:
    """Extract the banded extended-domain operators of each subdomain,
    bit-identical to the JAX package's plan.

    Raises NotImplementedFeature when the matrix is not banded enough for
    the DIA-only kernel.  ``oras_weight`` (c in [-1, 0], 0 = classical RAS)
    adds the O-RAS Robin term in preconditioner form: the correction solves
    use ``A_dom + c * D_drop`` with ``D_drop[i] = sum_k |A[i, i+o_k]|`` over
    couplings dropped at the artificial interface; the residual keeps A.

    The roundings (R to 128, ovp to 64, hw to 128) define the subdomains and
    the effective overlap, so they are the JAX package's exactly.
    """
    S = num_subdomains
    N = mat.n
    rows_of, diffs, offsets, R, ovp, hw = plan_geometry(mat, S, overlap)
    K = len(offsets)
    Np = S * R

    # global DIA on the padded row space; padding rows get identity diagonals
    gdia = np.zeros((K, Np), dtype=np.float32)
    off_pos = {o: k for k, o in enumerate(offsets)}
    for k, o in enumerate(offsets):
        sel = diffs == o
        gdia[k, rows_of[sel]] = mat.values[sel]
    gdia[off_pos[0], N:] = 1.0

    total = R + 2 * hw
    dia = np.zeros((S, K, total), dtype=np.float32)
    b = _window_rhs(rhs, S, R, hw, N)
    mask_dom = np.zeros((S, total), dtype=np.float32)
    mask_int = np.zeros((S, total), dtype=np.float32)
    dinv = np.ones((S, total), dtype=np.float32)
    for d in range(S):
        lo = d * R - hw                     # global row of TOTAL slot 0
        g0, g1 = max(lo, 0), min(lo + total, Np)
        dia[d, :, g0 - lo:g1 - lo] = gdia[:, g0:g1]
        dom_lo, dom_hi = max(d * R - ovp, 0), min((d + 1) * R + ovp, Np)
        mask_dom[d, dom_lo - lo:dom_hi - lo] = 1.0
        mask_int[d, hw:hw + R] = 1.0
        dg = dia[d, off_pos[0]]
        dinv[d] = np.where(np.abs(dg) > 0, 1.0 / np.where(dg == 0, 1, dg), 1.0)
    # outside the solve domain the operator acts as identity (see kernel);
    # zero those dia rows so A*v there contributes nothing
    dia *= mask_dom[:, None, :]

    boost = None
    if oras_weight:
        c = float(oras_weight)
        if not -1.0 <= c <= 0.0:
            raise ValueError(
                f"oras_weight={c} outside [-1, 0]: the Robin ghost "
                "elimination gives coefficients in (-1, 0] (0 = Dirichlet, "
                "-1 = Neumann limit); positive weights stiffen the solve "
                "operator in the wrong direction"
            )
        # c * sum of |couplings| whose target column falls outside the
        # solve domain; physical boundaries contribute nothing
        boost = np.zeros((S, total), np.float32)
        slot = np.arange(total)
        for d in range(S):
            in_dom = mask_dom[d] > 0
            for k, o in enumerate(offsets):
                if o == 0:
                    continue
                j = slot + o
                tgt_dom = np.zeros(total, dtype=bool)
                valid = (j >= 0) & (j < total)
                tgt_dom[valid] = in_dom[j[valid]]
                dropped = in_dom & ~tgt_dom
                boost[d, dropped] += np.abs(dia[d, k, dropped])
        boost *= c
        # Jacobi preconditioner of the boosted solve operator
        for d in range(S):
            dg = dia[d, off_pos[0]] + boost[d]
            dinv[d] = np.where(
                np.abs(dg) > 0, 1.0 / np.where(dg == 0, 1, dg), 1.0
            )

    return AsyncPlan(
        S=S, N=N, R=R, hw=hw, ovp=ovp, total=total, offsets=offsets,
        dia=dia, b=b, dinv=dinv, mask_dom=mask_dom, mask_int=mask_int,
        boost=boost,
    )


class AsyncRASolver:
    """Host driver: chunked launches of the free-running kernel (K5).

    Each launch runs ``chunk_rounds`` barrier-free rounds on every rank;
    between launches the host checks whether all ranks detected global
    convergence (the only global synchronization, mirroring the reference's
    outer ``max_iters`` bound, schwarz_base.cpp:387).  Runs on the CUDA
    device unless ``device`` names another; on the CPU the kernel's plain
    version runs.
    """

    def __init__(self, mat, rhs, num_subdomains: int, overlap: int = 2,
                 tolerance: float = 1e-6, staleness: int = 1,
                 ninner: int = 12, chunk_rounds: int = 16,
                 num_ranks: Optional[int] = None, device=None,
                 fresh_read: bool = False, oras_weight: float = 0.0,
                 nonsym: bool = False, nonsym_solver: str = "bicgstab",
                 mesh=None):
        num_ranks, device = mesh_ranks(mesh, num_ranks, device)
        self.device = resolve_device(device)
        self.plan = build_async_plan(mat, rhs, num_subdomains, overlap,
                                     oras_weight=oras_weight)
        self.oras_weight = float(oras_weight)
        self.nonsym = bool(nonsym)
        solver_kind(True, nonsym_solver)     # raises on an unknown name
        self.nonsym_solver = nonsym_solver
        self.mat = mat
        self.rhs = np.asarray(rhs)
        self.tolerance = tolerance
        self.staleness = staleness
        self.ninner = ninner
        self.chunk_rounds = chunk_rounds
        self.fresh_read = bool(fresh_read)
        S = num_subdomains
        D = S if num_ranks is None else int(num_ranks)
        if D < 1 or S % D:
            raise ValueError(
                f"free-running mode requires the subdomain count ({S}) to "
                f"be a multiple of the mesh size ({D})"
            )
        if D > LANES:
            raise ValueError(
                f"free-running mode keeps one gossip lane per rank: {D} "
                f"ranks exceed {LANES}; pass num_ranks, a divisor of {S} "
                f"of at most {LANES}")
        self.D = D
        self.Sl = S // D
        # the processes the ranks are dealt to (None: this process holds
        # all), and this process's ranks
        self._mesh = group_of(mesh)
        self.Dl = D if self._mesh is None else mesh.ranks_per_process
        self._ranks = (slice(0, D) if self._mesh is None
                       else self._mesh.block(D))
        p = self.plan
        self._dev = {
            "dia": self._fold(p.dia), "b": self._fold(p.b),
            "dinv": self._fold(p.dinv), "mask_dom": self._fold(p.mask_dom),
            "mask_int": self._fold(p.mask_int),
        }
        if p.boost is not None:
            self._dev["boost"] = self._fold(p.boost)

    def _fold(self, a: np.ndarray) -> torch.Tensor:
        """(S, [K,] total) plan array -> the rank layout on the device:
        (D, [K,] Sl*total), each rank's Sl windows contiguous; this
        process's ranks of it."""
        D, Sl = self.D, self.Sl
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dim() == 3:
            S, K, total = t.shape
            t = t.reshape(D, Sl, K, total).permute(0, 2, 1, 3)
            t = t.reshape(D, K, Sl * total)
        else:
            t = t.reshape(D, -1)
        return t[self._ranks].contiguous().to(self.device)

    def set_rhs(self, rhs) -> None:
        """Repack the RHS windows without rebuilding the plan (restarts of
        :func:`iterative_refinement_run` reuse the operator and masks)."""
        p = self.plan
        p.b = _window_rhs(rhs, p.S, p.R, p.hw, p.N)
        self.rhs = np.asarray(rhs)
        self._dev["b"] = self._fold(p.b)

    def run_refined(self, tol: float = 1e-10, max_restarts: int = 12,
                    max_rounds: int = 400, resume_state=None,
                    checkpoint_path: Optional[str] = None,
                    coarse_q: int = 0,
                    coarse_subdomains: Optional[int] = None):
        """f64-accurate solve via iterative-refinement restarts of the
        f32 free-running kernel (see :func:`iterative_refinement_run`)."""
        return iterative_refinement_run(
            self, tol=tol, max_restarts=max_restarts,
            max_rounds=max_rounds, resume_state=resume_state,
            checkpoint_path=checkpoint_path, coarse_q=coarse_q,
            coarse_subdomains=coarse_subdomains,
        )

    def save_checkpoint(self, state, path: str) -> None:
        """Persist a free-running state (x (S, R), known, aux, halo
        carries) in the JAX package's file format; across processes the
        blocks are gathered and process 0 writes the file."""
        x, known, aux, hl, hr = (gather(self._mesh, a) for a in state)
        write_once(self._mesh, lambda: np.savez_compressed(
            path, x.reshape(self.plan.S, self.plan.R), known, aux, hl, hr))

    def load_checkpoint(self, path: str):
        """A state written by :meth:`save_checkpoint` (or by the JAX
        package), this process's block of it."""
        # np.savez_compressed appends .npz to a suffix-less path; accept
        # the same path back (save/load symmetry)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as data:
            leaves = [cut(self._mesh, np.ascontiguousarray(
                data[f"arr_{i}"], np.float32)) for i in range(5)]
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in leaves)

    def init_state(self):
        """Fresh (x, known, aux, hl, hr) on the device: this process's
        subdomains and ranks."""
        p, Dl = self.plan, self.Dl
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=self.device)
        aux = torch.full((Dl, LANES), -1.0, dtype=torch.float32,
                         device=self.device)
        aux[:, 2] = 0.0   # base round counter
        return (z(Dl * self.Sl, p.R), z(Dl, LANES), aux, z(Dl, p.hw),
                z(Dl, p.hw))



    def run(self, max_rounds: int = 400, resume_state=None,
            checkpoint_path: Optional[str] = None):
        """Iterate chunks until every rank detected convergence.

        Returns (x_global, info): x in the original row ordering (float32),
        info with per-rank detection rounds (``done_at``, unequal under
        asynchrony), rounds executed, comm volume, and the true relative
        residual.  ``comm_bytes_per_device`` counts this port's messages:
        per round each rank sends two slots (hw strip + D known lanes as
        float32 + an 8-byte sequence word) and two 4-byte acknowledgements.
        """
        p, D, Sl = self.plan, self.D, self.Sl
        x, known, aux, hl, hr = (resume_state if resume_state is not None
                                 else self.init_state())
        x = x.reshape(self.Dl, Sl * p.R)
        dev = self._dev
        t0 = time.perf_counter()
        rounds = 0
        while rounds < max_rounds:
            x, known, aux, hl, hr = async_ras_rounds(
                dev["dia"], dev["b"], dev["dinv"], dev["mask_dom"],
                dev["mask_int"], x, known, aux, hl, hr, dev.get("boost"),
                offsets=p.offsets, total=p.total, hw=p.hw,
                rounds=self.chunk_rounds, staleness=self.staleness,
                ninner=self.ninner, tol=self.tolerance,
                fresh_read=self.fresh_read, nonsym=self.nonsym,
                nonsym_solver=self.nonsym_solver, mesh=self._mesh,
            )
            rounds += self.chunk_rounds
            if _all_done(self._mesh, aux):
                break
        aux_h = gather(self._mesh, aux)
        elapsed = time.perf_counter() - t0
        state = (x.reshape(-1, p.R), known, aux, hl, hr)
        if checkpoint_path is not None:
            self.save_checkpoint(state, checkpoint_path)
        sol = gather(self._mesh, x).reshape(-1)[:p.N]
        A = self.mat.to_scipy()
        res = self.rhs - A @ sol
        rel = float(np.linalg.norm(res) / max(np.linalg.norm(self.rhs),
                                              1e-300))
        done = aux_h[:, 1].astype(int)
        total_rounds = int(aux_h[0, 2])
        msg_bytes = (p.hw + D) * 4 + 8
        ack_bytes = 4
        return sol, {
            "done_at": done,
            "converged": bool(np.all(done >= 0)),
            "rounds": rounds,
            "total_rounds": total_rounds,
            "comm_bytes_per_device": total_rounds * 2 * (msg_bytes
                                                         + ack_bytes),
            "relative_residual_norm": rel,
            "time_s": elapsed,
            "effective_overlap": p.ovp,
            # total fresh-read hits across ranks (0 unless fresh_read and
            # staleness > 1)
            "fresh_read_hits": int(np.maximum(aux_h[:, 4], 0.0).sum()),
        }


def _all_done(mesh, aux: torch.Tensor) -> bool:
    """Whether every rank of the group detected convergence (aux lane 1):
    one decision a chunk, the same in every process."""
    done = aux[:, 1]
    if group_of(mesh) is not None:
        done = mesh.all_gather(done)
    return bool((done >= 0).all())


def iterative_refinement_run(solver, tol: float = 1e-10,
                             max_restarts: int = 12,
                             max_rounds: int = 400,
                             resume_state=None,
                             checkpoint_path: Optional[str] = None,
                             coarse_q: int = 0,
                             coarse_subdomains: Optional[int] = None):
    """f64-accurate solve from the f32 free-running kernel.

    Mixed-precision iterative refinement: the kernel solves ``A dx = r`` in
    f32 at its own relative tolerance; the true residual is recomputed on
    the host in f64 and the correction accumulated in f64.  ``tol`` is the
    target TRUE relative residual.  ``resume_state``: an accumulated f64
    solution (saved under ``ir_x`` by ``checkpoint_path``) to continue from.

    ``coarse_q`` > 0 is two-level asynchronous Schwarz: before every launch
    the host applies a spectral coarse correction (``core/coarse.py``
    ``HostCoarse``, q Neumann-block eigenvectors per coarse strip) to the
    float64 residual, so the barrier-free kernel only contracts the
    high-frequency remainder.  ``coarse_subdomains`` (the strips) defaults
    to the kernel's subdomain count.  Works with each free-running tier's
    solver.
    """
    A = solver.mat.to_scipy().astype(np.float64)
    rhs_orig = solver.rhs
    b0 = np.asarray(rhs_orig, np.float64)
    nb = float(np.linalg.norm(b0)) or 1.0
    coarse = None
    if coarse_q > 0:
        from schwarz_tpu_torch.core.coarse import (HostCoarse,
                                                   equal_strip_boundaries)

        S_c = coarse_subdomains or solver.plan.S
        coarse = HostCoarse(A, equal_strip_boundaries(b0.shape[0], S_c),
                            coarse_q)
    if resume_state is not None:
        x = np.asarray(resume_state, np.float64).copy()
        r = b0 - A @ x
    else:
        x = np.zeros(b0.shape[0], np.float64)
        r = b0.copy()
    infos = []
    rel = float(np.linalg.norm(r)) / nb
    try:
        for _ in range(max_restarts):
            if rel <= tol:
                break
            if coarse is not None:
                x += coarse.solve(r)
                r = b0 - A @ x
                rel = float(np.linalg.norm(r)) / nb
                if rel <= tol:
                    break
            s = float(np.max(np.abs(r)))
            if s == 0.0:
                rel = 0.0
                break
            solver.set_rhs(r / s)
            dx, info = solver.run(max_rounds=max_rounds)
            infos.append(info)
            x += s * np.asarray(dx, np.float64)
            r = b0 - A @ x
            prev, rel = rel, float(np.linalg.norm(r)) / nb
            if checkpoint_path is not None:
                write_once(getattr(solver, "_mesh", None),
                           lambda: np.savez_compressed(checkpoint_path,
                                                       ir_x=x))
            if rel > 0.5 * prev and coarse is None:
                # restart no longer reduces the true residual: the f32
                # kernel hit its conditioning floor — stop honestly.
                # (With the coarse step the next restart acts on a
                # different error split, so the plateau test would fire
                # spuriously; the restart budget bounds it instead.)
                break
    finally:
        solver.set_rhs(rhs_orig)
    last = infos[-1] if infos else {}
    return x, {
        "converged": rel <= tol,
        "restarts": len(infos),
        "relative_residual_norm": rel,
        "done_at": last.get("done_at", np.array([-1])),
        "rounds": int(sum(i["rounds"] for i in infos)),
        "time_s": float(sum(i["time_s"] for i in infos)),
        "fresh_read_hits": int(sum(i.get("fresh_read_hits", 0)
                                   for i in infos)),
        "inner_infos": infos,
    }
