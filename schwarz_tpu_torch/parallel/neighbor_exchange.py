"""Neighbour halo exchange: packed per-rank-pair buffers moved in
cyclic-offset rounds.

Port of ``schwarz_tpu/parallel/neighbor_exchange.py``, the analogue of the
reference's *gathered* two-sided exchange (Gather -> MPI_Isend / MPI_Irecv
-> Scatter, restricted_schwarz.cpp:855-973) and of the gathered one-sided
Put/Get (:714-852): per neighbour pair only the needed elements travel,
instead of the whole interior block as in the ``all_gather`` strategy.

The JAX package's mesh of D devices becomes D *ranks* on one card, each
owning ``Sl = S / D`` consecutive subdomains; all ranks are handled at once,
with the rank as a leading axis.  Across processes (a
:class:`~schwarz_tpu_torch.parallel.mesh.Mesh` of several) a process
handles its own D / P ranks the same way, with the tables sliced to them
(:func:`exchange_rounds`).  In round ``r`` every rank ``d`` sends one
packed buffer to rank ``(d + r) % D``, a pure cyclic shift: ``torch.roll``
for the two-sided ``neighbor`` strategy (a plain collective in the JAX
package; ``Mesh.shift`` across processes), kernel K4
(:func:`schwarz_tpu_torch.ops.rdma_kernel.rdma_cyclic_shift`) for the
one-sided ``rdma`` strategy, where one K4
launch runs every round of an exchange with its pack and unpack; across
processes each process launches it for its ranks, which put into a peer
process's ranks' windows through the mesh's CUDA IPC window.  Only
offsets with any traffic get a round: a regular 1-D partition needs 2
rounds, a 2-D grid partition about 8, whatever the rank count.

All tables are static, built on the host at setup:

  - ``send_idx[r]`` (D, H_r): flat offsets into the sender's interior block,
    row d = what (d + r_offset) % D needs from d, in ascending
    permuted-global order (the agreed buffer order).
  - ``recv_round`` (S, H): which round delivers each halo slot (n_rounds =
    local).
  - ``recv_pos`` (S, H): position of the slot's value in that round's buffer.
  - ``local_src`` (S, H): intra-rank flat offset for slots whose owner lives
    on the same rank; such slots never cross the transport.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from schwarz_tpu_torch.ops.rdma_kernel import (ExchangeRounds,
                                               exchange_rounds_plain,
                                               rdma_exchange_launch,
                                               rdma_shift_finish)
from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext


@dataclasses.dataclass
class NeighborPlan:
    """Host-side tables for the offset-round exchange (see module docstring).

    Receive-side tables are *compact*: aligned with ``dec.halo_slots`` (S, H),
    covering only the non-interior valid ext slots.  Field names are the JAX
    package's; ``n_devices`` is the rank count.
    """

    n_devices: int
    offsets: List[int]                 # cyclic rank offsets, one per round
    send_idx: List[np.ndarray]         # per round: (D, H_r) int32
    is_local: np.ndarray               # (S, H) bool: owner on the same rank
    local_src: np.ndarray              # (S, H) int32 into (Sl*R_int,)
    recv_round: np.ndarray             # (S, H) int32 (n_rounds where local)
    recv_pos: np.ndarray               # (S, H) int32
    max_h: int                         # max buffer length across rounds
    round_is_dcn: List[bool] = None    # per round: any cross-host link


def build_neighbor_plan(
    dec, n_ranks: int, process_of=None,
) -> NeighborPlan:
    """Derive the round tables from a Decomposition for D ranks.

    ``process_of`` (D,) maps rank -> host process.  When given, rounds are
    ordered **intra-host first**: cyclic offsets whose active links all stay
    inside a host run before any round that crosses hosts (the reference's
    check_subd_locality, source/utils.cpp:41-78).  With one host every
    round is intra-host and the order is the offset order."""
    meta = dec.meta
    S = meta.num_subdomains
    D = n_ranks
    assert S % D == 0
    Sl = S // D
    R_int = meta.max_interior
    first_row = dec.first_row

    # per halo slot (compact table): permuted-global index + owner
    H = dec.halo_slots.shape[1]
    pad_slot = dec.halo_slots == meta.max_ext   # scratch-padding entries
    slot_safe = np.where(pad_slot, 0, dec.halo_slots)
    g_of = np.take_along_axis(dec.local_to_global, slot_safe.astype(np.int64), 1)
    g_of = np.where(pad_slot, 0, g_of)          # padding -> global row 0
    owner = np.searchsorted(first_row, g_of, side="right") - 1
    owner_dev = owner // Sl
    my_dev = (np.arange(S) // Sl)[:, None]

    is_local = (owner_dev == my_dev) | pad_slot  # padding handled as local 0
    local_src = ((owner - (my_dev * Sl)) * R_int + (g_of - first_row[owner]))
    local_src = np.where(is_local & ~pad_slot, local_src, 0).astype(np.int32)

    # needed[d][e] = sorted unique permuted-global indices rank d needs from e
    needed = [[None] * D for _ in range(D)]
    for d in range(D):
        subs = range(d * Sl, (d + 1) * Sl)
        for e in range(D):
            if e == d:
                continue
            vals = np.concatenate(
                [g_of[p][~is_local[p] & (owner_dev[p] == e)] for p in subs]
            )
            needed[d][e] = np.unique(vals)

    offsets = []
    for r in range(1, D):
        if any(needed[(e + r) % D][e].size for e in range(D)):
            offsets.append(r)
    round_is_dcn = [False] * len(offsets)
    if process_of is not None:
        proc = np.asarray(process_of)
        round_is_dcn = [
            any(
                needed[(e + r) % D][e].size
                and proc[(e + r) % D] != proc[e]
                for e in range(D)
            )
            for r in offsets
        ]
        # intra-host first: stable sort keeps the offset order within a class
        order = sorted(range(len(offsets)), key=lambda k: round_is_dcn[k])
        offsets = [offsets[k] for k in order]
        round_is_dcn = [round_is_dcn[k] for k in order]

    send_idx: List[np.ndarray] = []
    n_rounds = len(offsets)
    recv_round = np.full((S, H), n_rounds, dtype=np.int32)
    recv_pos = np.zeros((S, H), dtype=np.int32)
    max_h = 1
    for k, r in enumerate(offsets):
        H_r = max(max(needed[(e + r) % D][e].size for e in range(D)), 1)
        max_h = max(max_h, H_r)
        tbl = np.zeros((D, H_r), dtype=np.int32)
        for e in range(D):       # sender e -> receiver d = (e + r) % D
            d = (e + r) % D
            g = needed[d][e]
            if g.size == 0:
                continue
            own_sub = np.searchsorted(first_row, g, side="right") - 1
            tbl[e, : g.size] = (
                (own_sub - e * Sl) * R_int + (g - first_row[own_sub])
            )
            # receiver side: every halo slot of d's subdomains owned by e
            pos_of = {int(gi): i for i, gi in enumerate(g)}
            for p in range(d * Sl, (d + 1) * Sl):
                hs = np.where(~is_local[p] & (owner_dev[p] == e))[0]
                for j in hs:
                    recv_round[p, j] = k
                    recv_pos[p, j] = pos_of[int(g_of[p, j])]
        send_idx.append(tbl)

    return NeighborPlan(
        n_devices=D,
        offsets=offsets,
        send_idx=send_idx,
        is_local=is_local,
        local_src=local_src,
        recv_round=recv_round,
        recv_pos=recv_pos,
        max_h=max_h,
        round_is_dcn=round_is_dcn,
    )


def exchange_rounds(nx: NeighborPlan, device, mesh=None) -> ExchangeRounds:
    """The plan's round tables as tensors on ``device``, built once per
    solver: K4 keeps its own tables and sequence words with them.  Under a
    ``mesh`` of several processes, the send tables of the process's ranks
    and the receive tables of its subdomains, and K4's window on the
    mesh."""
    ranks = subs = slice(None)
    n_ranks = nx.n_devices
    if mesh is not None:
        ranks = mesh.block(nx.n_devices)
        subs = mesh.block(nx.is_local.shape[0])
        n_ranks = mesh.ranks_per_process

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    i64 = lambda a: t(a.astype(np.int64))  # noqa: E731
    return ExchangeRounds(
        [i64(s[ranks]) for s in nx.send_idx], nx.offsets,
        i64(nx.recv_round[subs]), i64(nx.recv_pos[subs]),
        i64(nx.local_src[subs]), t(nx.is_local[subs]), n_ranks, nx.max_h,
        mesh)


def exchange_halo_neighbor(
    x_own: torch.Tensor,            # (S, R_int) every subdomain's interior
    segments,                       # (segs, first): segments_of(dec, True)
    rounds: ExchangeRounds,         # the plan's round tables
    r_ext: int,
    halo_dtype: Optional[torch.dtype] = None,
    transport: str = "ppermute",    # "ppermute" (two-sided) | "rdma" (one-sided)
    rdma_mode: str = "put",         # "put" | "get" (comm_helpers.hpp:55-127)
    rdma_one_by_one: bool = False,  # per-element transfers (hpp:58-89)
    rdma_flush_local: bool = False,  # per-transfer completion (hpp:128-149)
    pending: Optional[list] = None,  # collects the K4 launches' status words
    shift=None,                     # Mesh.shift across processes
) -> torch.Tensor:
    """Run the offset rounds of all D ranks and assemble x_ext (S, R_ext).

    Only the O(halo) compact tables go through the rounds.  Values that
    cross ranks travel in ``halo_dtype``; slots owned by the same rank are
    read from the rank's own block, unrounded.  On the ``rdma`` transport
    the whole exchange (every round, pack and unpack) is one K4 launch; its
    watchdog word is read at once (one host sync), or, when the caller
    passes a ``pending`` list, left in it for the caller to hand to
    ``rdma_shift_finish`` at its own next sync, so that the host can run
    ahead of the card.  x_ext is then one K2 launch over the compact halo
    values: window, halo and zeros.  ``shift`` moves a round's buffers on
    the two-sided transport (``torch.roll`` over the ranks by default).
    """
    if transport == "rdma":
        halo_vals, status = rdma_exchange_launch(
            x_own, rounds, halo_dtype, rdma_mode, rdma_one_by_one,
            rdma_flush_local)
        if pending is None:
            rdma_shift_finish([status])
        else:
            pending.append(status)
    else:
        halo_vals = exchange_rounds_plain(
            x_own, rounds, halo_dtype,
            shift or (lambda buf, r: torch.roll(buf, r, 0)))
    return assemble_x_ext(x_own, halo_vals, *segments, r_ext)
