"""Free-running asynchronous RAS on arbitrary graphs: the port of
``schwarz_tpu/ops/async_ras_general.py``.

Extends the banded 1-D tier (:mod:`.async_ras`) and the 2-D block-grid tier
(:mod:`.async_ras_2d`) to ANY matrix with ANY partition (metis partitions of
the anisotropic FEM matrices ``ani3``/``ani4``, custom ``partition_indices``,
operators the other tiers refuse): the full scope of the reference's
asynchronous mode (source/restricted_schwarz.cpp:714-852 on the subdomain
graph found by the neighbour handshake, :307-604).

What defines the iteration is the JAX package's, value for value:

- **The rank is the subdomain.**  Each rank's extended system is its owned
  rows, the breadth-first closure of depth ``max(overlap, 1)`` around them,
  and one Dirichlet frontier ring; halo slots are ordered by (owner, id).
- **Edge-coloured links.**  The subdomain adjacency graph is greedily
  edge-coloured over its sorted edges, so a rank has at most one link per
  colour and a message is addressed by (round slot, rank, colour).  A rank
  that lacks a colour has itself as that colour's target and nothing to send.
- **Symmetric Jacobi scaling.**  The kernel solves ``(Ds A Ds) y = Ds b``
  with the global ``Ds = diag(|diag A|^-1/2)``; ``x = Ds y`` at extraction.
- **In-band gossip**, chunked launches and the warm-up carry of the last
  message are those of the 1-D tier, per coloured link.

What is the card's own: the extended operators are kept in padded ELL form
(``cols``, ``vals``, entries of a row in slot order) and packing and unpacking
are index tables (``send_idx``, ``recv_slot``).  The JAX package's dense
operators and one-hot pack/unpack matrices exist there to turn gathers into
matrix products; :meth:`GeneralAsyncPlan.dense` rebuilds them from the index
form, bit for bit, for comparison.  Its table-precision modes and its memory
and semaphore gates size that hardware's scratch memory and have no
counterpart here; K7's wrapper refuses a rank count the card cannot hold
co-resident.

``mesh`` deals the S ranks (one per subdomain) to the processes of a group,
S / P consecutive ranks each: each process keeps and launches its ranks,
``run`` gathers the iterate and the aux lanes, and the checkpoints hold the
whole state in the JAX package's layout (the x128 ``aux`` scaling kept).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from schwarz_tpu_torch.core.partition import (
    _csr_row_gather,
    partition_regular_1d,
)
from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops.async_ras import (_all_done, _mesh_ranks,
                                             iterative_refinement_run)
from schwarz_tpu_torch.parallel.mesh import cut, gather, group_of, write_once
from schwarz_tpu_torch.ops.async_ras_2d import _round_up, check_oras_weight
from schwarz_tpu_torch.ops.async_ras_general_kernel import (  # noqa: F401
    LANES,
    async_general_rounds,
    async_general_rounds_plain,
    ell_planes,
)


@dataclasses.dataclass
class GeneralAsyncPlan:
    """Host-side static tables for the general free-running kernel."""

    S: int
    N: int
    Rint: int               # padded interior rows per rank
    H: int                  # padded halo slots per rank
    Rext: int               # Rint + H
    SEG: int                # padded message width (values per link)
    C: int                  # number of link colors
    K: int                  # ELL width: most entries in one extended row
    n_int: np.ndarray       # (S,) true interior counts
    int_ids: tuple          # per-rank interior global ids (ascending)
    cols: np.ndarray        # (S, Rext, K) int32 local slot of each entry
    vals: np.ndarray        # (S, Rext, K) f32 scaled entries, slot order
    b: np.ndarray           # (S, Rext) f32
    dinv: np.ndarray        # (S, Rext) f32 Jacobi inverse diagonal
    mask_dom: np.ndarray    # (S, Rext) f32 — solve domain rows
    mask_int: np.ndarray    # (S, Rext) f32 — owned interior rows
    send_idx: np.ndarray    # (S, C, SEG) int32 interior position, or -1
    recv_slot: np.ndarray   # (S, C, SEG) int32 halo slot, or -1
    tgt_subd: np.ndarray    # (S, C) int32 partner rank (self for dummies)
    send_len: np.ndarray    # (S, C) int32 true values sent on each link
    gid: np.ndarray         # (S, Rext) int32 global row per slot (-1 pad)
    scale: np.ndarray = None  # (N,) f64 symmetric Jacobi scale d^{-1/2}
    boost: "np.ndarray | None" = None   # (S, Rext) O-RAS Robin diag term

    def dense_operator(self, s: int) -> np.ndarray:
        """Rank ``s``'s (Rext, Rext) dense extended operator."""
        A = np.zeros((self.Rext, self.Rext), np.float32)
        rows = np.broadcast_to(np.arange(self.Rext)[:, None],
                               self.cols[s].shape)
        nz = self.vals[s] != 0
        A[rows[nz], self.cols[s][nz]] = self.vals[s][nz]
        return A

    def dense(self):
        """(A, OH, U): the dense extended operators (S, Rext, Rext) and the
        one-hot pack (S, C, SEG, Rint) and unpack (S, C, H, SEG) matrices of
        the JAX package's plan, rebuilt from the index form."""
        S, C, SEG = self.S, self.C, self.SEG
        A = np.stack([self.dense_operator(s) for s in range(S)])
        OH = np.zeros((S, C, SEG, self.Rint), np.float32)
        U = np.zeros((S, C, self.H, SEG), np.float32)
        s, c, k = np.nonzero(self.send_idx >= 0)
        OH[s, c, k, self.send_idx[s, c, k]] = 1.0
        s, c, k = np.nonzero(self.recv_slot >= 0)
        U[s, c, self.recv_slot[s, c, k], k] = 1.0
        return A, OH, U


def build_general_plan(mat, rhs, part, overlap: int,
                       oras_weight: float = 0.0) -> GeneralAsyncPlan:
    """Extract the extended operators and the edge-coloured link tables.

    ``mat``: CSRMatrix; ``part``: (N,) subdomain id per row (any partition,
    e.g. ``core.partition.make_partition`` metis output); ``overlap`` >= 1.
    ``oras_weight`` adds the O-RAS Robin diagonal on solve-domain rows with
    couplings dropped at the artificial interface (preconditioner form, see
    ``async_ras.build_async_plan``).
    """
    A_sp = mat.to_scipy().tocsr()
    N = A_sp.shape[0]
    part = np.asarray(part, np.int64)
    if part.shape != (N,):
        raise ValueError(f"partition shape {part.shape} != ({N},)")
    S = int(part.max()) + 1
    if S > LANES:
        raise NotImplementedFeature(
            "free-running gossip packs one lane per rank: S <= 128"
        )
    ovp = max(int(overlap), 1)
    G = A_sp != 0
    G = ((G + G.T) > 0).tocsr()

    # Symmetric Jacobi scaling (global, so every rank scales a shared row
    # identically): the kernel solves  (Ds A Ds) y = Ds b  with
    # Ds = diag(|diag A|^{-1/2}) and x = Ds y recovered at extraction.
    dg = A_sp.diagonal()
    with np.errstate(divide="ignore"):
        dscale = np.where(dg != 0, 1.0 / np.sqrt(np.abs(dg)), 1.0)

    int_ids = tuple(np.flatnonzero(part == s) for s in range(S))
    if any(ids.size == 0 for ids in int_ids):
        raise ValueError("empty subdomain in partition")

    # BFS closure (depth ovp) + one Dirichlet frontier ring per rank
    closures, frontiers = [], []
    for s in range(S):
        in_clos = np.zeros(N, dtype=bool)
        in_clos[int_ids[s]] = True
        layer = int_ids[s]
        for _ in range(ovp):
            nxt = np.unique(G[layer].indices)
            layer = nxt[~in_clos[nxt]]
            in_clos[layer] = True
        nxt = np.unique(G[np.flatnonzero(in_clos)].indices)
        fr = nxt[~in_clos[nxt]]
        closures.append(np.flatnonzero(in_clos))
        frontiers.append(np.sort(fr))

    # halo = (closure - interior) + frontier, grouped by owner, sorted
    halo_ids, halo_by_owner = [], []
    for s in range(S):
        clos_non_int = np.setdiff1d(closures[s], int_ids[s],
                                    assume_unique=True)
        hid = np.union1d(clos_non_int, frontiers[s])
        owners = part[hid]
        order = np.lexsort((hid, owners))
        hid = hid[order]
        halo_ids.append(hid)
        by = {}
        for o in np.unique(owners[order]):
            by[int(o)] = hid[owners[order] == o]
        halo_by_owner.append(by)

    # links: undirected edges where either side needs values
    edges = set()
    for s in range(S):
        for o in halo_by_owner[s]:
            if o != s:
                edges.add((min(s, o), max(s, o)))
    # greedy edge coloring: at most one link per color per rank
    color_of = {}
    used = [set() for _ in range(S)]
    for e in sorted(edges):
        a, bb = e
        c = 0
        while c in used[a] or c in used[bb]:
            c += 1
        color_of[e] = c
        used[a].add(c)
        used[bb].add(c)
    C = max((c for c in color_of.values()), default=-1) + 1
    C = max(C, 1)

    n_int = np.array([ids.size for ids in int_ids], np.int64)
    n_halo = np.array([h.size for h in halo_ids], np.int64)
    # multiples of 128, as in the JAX package: the shapes of the state and of
    # the checkpoint files depend on them
    Rint = _round_up(int(n_int.max()), 128)
    H = _round_up(int(n_halo.max()), 128)
    Rext = Rint + H
    seg_max = 1
    for s in range(S):
        for o, ids in halo_by_owner[s].items():
            if o != s:
                seg_max = max(seg_max, ids.size)
    SEG = _round_up(seg_max, 128)

    b = np.zeros((S, Rext), np.float32)
    dinv = np.ones((S, Rext), np.float32)
    mask_dom = np.zeros((S, Rext), np.float32)
    mask_int = np.zeros((S, Rext), np.float32)
    send_idx = np.full((S, C, SEG), -1, np.int32)
    recv_slot = np.full((S, C, SEG), -1, np.int32)
    tgt_subd = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, C))
    send_len = np.zeros((S, C), np.int32)
    gid = np.full((S, Rext), -1, np.int32)
    rhs_np = np.asarray(rhs, np.float64)
    indptr = A_sp.indptr.astype(np.int64)

    slot_maps = []
    entries = []    # per rank: (row slot, column slot, value) sorted by both
    for s in range(S):
        slot_of = np.full(N, -1, np.int64)
        slot_of[int_ids[s]] = np.arange(n_int[s])
        slot_of[halo_ids[s]] = Rint + np.arange(n_halo[s])
        slot_maps.append(slot_of)
        ext = np.concatenate([int_ids[s], halo_ids[s]])
        gid[s, slot_of[ext]] = ext
        dom = closures[s]
        di = slot_of[dom]
        mask_dom[s, di] = 1.0
        b[s, di] = rhs_np[dom] * dscale[dom]
        # rows of the solve domain; off-domain (frontier) and padding rows
        # stay ZERO: with b = 0 and zero rows there, the residual and every
        # CG direction vanish on those slots
        e = _csr_row_gather(indptr, dom)
        g = np.repeat(dom, indptr[dom + 1] - indptr[dom])
        gc = A_sp.indices[e]
        i, j = slot_of[g], slot_of[gc]
        assert (j >= 0).all(), "BFS closure must contain every domain coupling"
        v = (A_sp.data[e] * dscale[g] * dscale[gc]).astype(np.float32)
        # a repeated (row, column) keeps its last entry, as an assignment
        # into a dense operator does
        order = np.lexsort((np.arange(e.size), j, i))
        i, j, v = i[order], j[order], v[order]
        last = np.ones(e.size, bool)
        last[:-1] = (i[1:] != i[:-1]) | (j[1:] != j[:-1])
        i, j, v = i[last], j[last], v[last]
        on_diag = i == j
        d = np.zeros(Rext, np.float32)
        d[i[on_diag]] = v[on_diag]
        dinv[s, di] = np.where(d[di] != 0,
                               1.0 / np.where(d[di] == 0, 1, d[di]), 1.0)
        keep = v != 0
        entries.append((i[keep], j[keep], v[keep]))
        mask_int[s, : n_int[s]] = 1.0

    K = max([1] + [int(np.bincount(i).max()) for i, _, _ in entries
                   if i.size])
    cols = np.zeros((S, Rext, K), np.int32)
    vals = np.zeros((S, Rext, K), np.float32)
    for s, (i, j, v) in enumerate(entries):
        start = np.searchsorted(i, i, side="left")
        k = np.arange(i.size) - start
        cols[s, i, k] = j
        vals[s, i, k] = v

    # links (a link may be one-sided: only one end needs values)
    for (a, bb), c in color_of.items():
        for s, o in ((a, bb), (bb, a)):
            tgt_subd[s, c] = o
            # pack: what o needs from me, in o's halo order
            send_ids = halo_by_owner[o].get(s, np.empty(0, np.int64))
            send_len[s, c] = send_ids.size
            send_idx[s, c, : send_ids.size] = slot_maps[s][send_ids]
            # unpack: what I need from o -> my halo slots
            recv_ids = halo_by_owner[s].get(o, np.empty(0, np.int64))
            recv_slot[s, c, : recv_ids.size] = slot_maps[s][recv_ids] - Rint

    plan = GeneralAsyncPlan(
        S=S, N=N, Rint=Rint, H=H, Rext=Rext, SEG=SEG, C=C, K=K,
        n_int=n_int, int_ids=int_ids, cols=cols, vals=vals, b=b, dinv=dinv,
        mask_dom=mask_dom, mask_int=mask_int, send_idx=send_idx,
        recv_slot=recv_slot, tgt_subd=tgt_subd, send_len=send_len, gid=gid,
        scale=dscale, boost=None,
    )
    if oras_weight:
        c0 = check_oras_weight(oras_weight)
        # couplings of solve-domain rows to non-domain slots (the frontier
        # ring the restricted CG treats as Dirichlet).  The JAX package sums
        # these over a dense row with np.einsum in float32; one rank's dense
        # rows at a time through the same call give the same bits.
        boost = np.zeros((S, Rext), np.float32)
        dg = np.zeros((S, Rext), np.float32)
        for s in range(S):
            A_s = plan.dense_operator(s)[None]
            boost[s] = (c0 * np.einsum(
                "sij,sj->si", np.abs(A_s), 1.0 - mask_dom[s:s + 1]
            ) * mask_dom[s:s + 1]).astype(np.float32)[0]
            dg[s] = np.einsum("sii->si", A_s)[0] + boost[s]
        plan.boost = boost
        plan.dinv = np.where(
            (np.abs(dg) > 0) & (mask_dom > 0),
            1.0 / np.where(dg == 0, 1, dg), 1.0
        ).astype(np.float32)
    return plan


class AsyncGeneralRASolver:
    """Host side of the general-graph free-running kernel K7.

    Same chunked-launch surface as :class:`.async_ras.AsyncRASolver`; works
    on any matrix/partition pair.  ``part=None`` uses regular 1-D blocks.
    ``num_ranks`` takes the place of the JAX package's mesh: there the S
    ranks fold onto that many devices, which changes no bit of the result,
    so here the kernel always runs one rank per subdomain and ``num_ranks``
    is only checked.  Runs on the CUDA device unless ``device`` names
    another; on the CPU the kernel's plain version runs.
    """

    def __init__(self, mat, rhs, num_subdomains: int, overlap: int = 2,
                 tolerance: float = 1e-6, staleness: int = 1,
                 ninner: int = 12, chunk_rounds: int = 16,
                 part=None, num_ranks: Optional[int] = None, device=None,
                 oras_weight: float = 0.0, nonsym: bool = False, mesh=None):
        from schwarz_tpu_torch.ras import resolve_device

        num_ranks, device = _mesh_ranks(mesh, num_ranks, device)
        self.device = resolve_device(device)
        S = num_subdomains
        if part is None:
            part = partition_regular_1d(mat.n, S)
        self.plan = build_general_plan(mat, rhs, part, overlap,
                                       oras_weight=oras_weight)
        self.oras_weight = float(oras_weight)
        self.nonsym = bool(nonsym)
        if self.plan.S != S:
            raise ValueError(
                f"partition has {self.plan.S} parts, expected {S}"
            )
        self.mat = mat
        self.rhs = np.asarray(rhs)
        self.tolerance = tolerance
        self.staleness = staleness
        self.ninner = ninner
        self.chunk_rounds = chunk_rounds
        D = S if num_ranks is None else int(num_ranks)
        if D < 1 or S % D:
            raise ValueError(
                f"free-running mode requires S ({S}) % devices ({D}) == 0"
            )
        self.D, self.Sl = D, S // D
        # the processes the kernel's S ranks are dealt to (None: this
        # process holds all)
        self._mesh = group_of(mesh)
        p = self.plan
        self._dev = {k: self._local(getattr(p, k))
                     for k in ("b", "dinv", "mask_int", "send_idx",
                               "recv_slot", "tgt_subd")}
        self._dev["cols"], self._dev["vals"] = ell_planes(
            self._local(p.cols), self._local(p.vals))
        if p.boost is not None:
            self._dev["boost"] = self._local(p.boost)

    def _local(self, a: np.ndarray) -> torch.Tensor:
        """This process's ranks' rows of a plan array, on the device."""
        return torch.from_numpy(np.ascontiguousarray(
            cut(self._mesh, a))).to(self.device)

    def set_rhs(self, rhs) -> None:
        """Repack the per-rank RHS slots without rebuilding the plan
        (restarts reuse the operators and link tables)."""
        p = self.plan
        r = np.asarray(rhs, np.float64) * p.scale
        p.b = (p.mask_dom * r[np.clip(p.gid, 0, p.N - 1)]).astype(np.float32)
        self.rhs = np.asarray(rhs)
        self._dev["b"] = self._local(p.b)

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
        """Persist a free-running state (x, known, aux, carry) in the JAX
        package's file format: x replicated over 128 lanes,
        (S*Rint, 128); known and aux as 8-row tiles, (S*8, 128); each
        carried message as SEG/128 tiles of 8 rows whose first row holds
        128 values, (S*C*8*SEG/128, 128).  The JAX package's dot products
        also sum over the 128 replicated lanes, so its two squared residual
        norms (aux lanes 0 and 3) are 128 times the port's: scaled here and
        back in :meth:`load_checkpoint`, exactly, by a power of two.  Across
        processes the blocks are gathered and process 0 writes the file."""
        p = self.plan
        x, known, aux, carry = (gather(self._mesh, a) for a in state)
        aux = aux.copy()
        aux[:, [0, 3]] = np.where(aux[:, [0, 3]] > 0,
                                  aux[:, [0, 3]] * LANES, aux[:, [0, 3]])
        SEGT = p.SEG // 128
        packed = np.zeros((p.S * p.C * SEGT, 8, 128), np.float32)
        packed[:, 0] = carry.reshape(-1, 128)
        write_once(self._mesh, lambda: np.savez_compressed(
            path,
            np.repeat(x.reshape(-1, 1), 128, axis=1),
            np.repeat(known, 8, axis=0), np.repeat(aux, 8, axis=0),
            packed.reshape(-1, 128)))

    def load_checkpoint(self, path: str):
        # np.savez_compressed appends .npz to a suffix-less path; accept
        # the same path back (save/load symmetry)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        data = np.load(path)
        p = self.plan
        x, known, aux, carry = (np.asarray(data[f"arr_{i}"], np.float32)
                                for i in range(4))
        aux = aux[::8].copy()
        aux[:, [0, 3]] = np.where(aux[:, [0, 3]] > 0,
                                  aux[:, [0, 3]] / LANES, aux[:, [0, 3]])
        state = (x[:, 0].reshape(p.S, p.Rint), known[::8], aux,
                 carry.reshape(-1, 8, 128)[:, 0].reshape(p.S, p.C, p.SEG))
        return tuple(self._local(a) for a in state)

    def init_state(self):
        """Fresh (x (S, Rint), known (S, 128), aux (S, 128), carry
        (S, C, SEG)) on the device: this process's ranks."""
        p = self.plan
        S = p.S if self._mesh is None else p.S // self._mesh.num_processes
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=self.device)
        aux = torch.full((S, LANES), -1.0, dtype=torch.float32,
                         device=self.device)
        aux[:, 2] = 0.0   # base round counter
        return z(S, p.Rint), z(S, LANES), aux, z(S, p.C, p.SEG)

    def launch(self, x, known, aux, carry, fn=async_general_rounds):
        """One launch: ``chunk_rounds`` rounds of all ranks.  ``fn`` is
        K7's wrapper or its plain version."""
        d = self._dev
        return fn(
            d["cols"], d["vals"], d["b"], d["dinv"], d["mask_int"],
            d["send_idx"], d["recv_slot"], d["tgt_subd"], x, known, aux,
            carry, d.get("boost"), rounds=self.chunk_rounds,
            staleness=self.staleness, ninner=self.ninner,
            tol=self.tolerance, nonsym=self.nonsym, mesh=self._mesh,
        )

    def run(self, max_rounds: int = 400, resume_state=None,
            checkpoint_path: Optional[str] = None):
        """Chunked launches until every rank detects global convergence.

        Returns (x_global, info).  ``comm_bytes_per_rank`` counts this
        port's messages: per round and colour a rank sends one slot (SEG
        float32 values, 128 known lanes as float32 and an 8-byte sequence
        word) and one 4-byte acknowledgement."""
        p = self.plan
        S = p.S
        state = (resume_state if resume_state is not None
                 else self.init_state())
        t0 = time.perf_counter()
        rounds = 0
        while rounds < max_rounds:
            state = self.launch(*state)
            rounds += self.chunk_rounds
            if _all_done(self._mesh, state[2]):
                break
        aux_h = gather(self._mesh, state[2])
        elapsed = time.perf_counter() - t0
        if checkpoint_path is not None:
            self.save_checkpoint(state, checkpoint_path)
        x_h = gather(self._mesh, state[0])
        sol = np.zeros(p.N, np.float32)
        for s in range(S):
            # kernel state is the Jacobi-scaled unknown y; x = Ds y
            sol[p.int_ids[s]] = (
                x_h[s, : p.n_int[s]] * p.scale[p.int_ids[s]]
            ).astype(np.float32)
        A_sp = self.mat.to_scipy()
        res = self.rhs - A_sp @ sol
        rel = float(
            np.linalg.norm(res) / max(np.linalg.norm(self.rhs), 1e-300)
        )
        done = aux_h[:, 1].astype(int)
        total_rounds = int(aux_h[0, 2])
        msg_bytes = (p.SEG + LANES) * 4 + 8
        return sol, {
            "done_at": done,
            "converged": bool(np.all(done >= 0)),
            "rounds": rounds,
            "total_rounds": total_rounds,
            "colors": p.C,
            "comm_bytes_per_rank": total_rounds * p.C * (msg_bytes + 4),
            "relative_residual_norm": rel,
            "time_s": elapsed,
        }
