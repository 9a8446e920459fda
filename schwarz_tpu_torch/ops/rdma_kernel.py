"""K4: the one-sided neighbour halo exchange, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/parallel/neighbor_exchange.py`` ``_rdma_cyclic_shift``
(:167) and the pack and unpack gathers around it.  One launch runs every
round of an exchange: in round k rank ``d`` packs what rank
``(d + r_k) % D`` needs from its interior block, casts it to the halo type
and moves it into that rank's receive window; after its last round a rank
unpacks its own subdomains' halo slots (``halo_vals`` (S, H), slots owned
on the same rank read from its own block, unrounded).  The moves are the
reference's one-sided transfers: put or get, one transfer per buffer or per
element, flush-all or flush-local (source and protocol:
``csrc/rdma_shift.cu``).  A rank is a thread block of one cooperative
launch; ranks signal each other through counters in device memory.  The
variants move the same data, so the kernel also reports, per round and
rank, the completion signals it received (1, or H_k one by one) and the
requests it served (1 in get mode, else 0).

The counters are 64-bit sequence words, allocated zeroed once per plan and
card (:class:`ExchangeRounds`, or per buffer shape for the one-round
:func:`rdma_cyclic_shift`) and carried from launch to launch: the host
counts the launches by kind and passes those totals, from which each rank
derives the value its waits must reach.  A rank whose wait outlasts the
kernel's watchdog sets a sticky abort word, which :func:`rdma_shift_finish`
turns into a ``RuntimeError``; it then drops every set of counters, so the
next launch starts from fresh ones.

On CPU tensors the wrappers take the plain versions below; on CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from schwarz_tpu_torch.ops import cuda_build

MODES = ("put", "get")
WAITED_FOR = {4: "a request from the rank it serves",
              5: "its source rank's data"}
# the kernel's element codes: bits for the shift, values for the exchange
_BITS = {2: 0, 4: 1, 8: 2}
_VALUES = {torch.float32: 3, torch.float64: 4, torch.bfloat16: 5,
           torch.float16: 6}
_COMPUTE = (torch.float32, torch.float64)

_caps: dict = {}                      # (device, tc, tw) -> co-resident blocks
_shift_cards: dict = {}               # (device, D, H, offset) -> _Card
_live_cards = weakref.WeakSet()       # every _Card, dropped after a fault


def rdma_cyclic_shift_plain(
    buf: torch.Tensor, offset: int, mode: str = "put",
    one_by_one: bool = False, flush_local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same shift as one ``torch.roll``, with the counters by formula:
    per rank [completion signals received, requests served]."""
    del flush_local              # changes the order of the signals only
    D, H = buf.shape
    counts = torch.empty((D, 2), dtype=torch.int32, device=buf.device)
    counts[:, 0] = H if one_by_one else 1
    counts[:, 1] = 1 if mode == "get" else 0
    return torch.roll(buf, offset, 0), counts


class _Card:
    """K4's state for one round structure on one card: the round table
    (offset, H_k, window base), the cumulative sequence words (receive and
    request counters per round and rank, the finished counter, the abort
    word), zeroed once, and the host's launch totals (whole-buffer,
    one-by-one, get, all)."""

    def __init__(self, offsets, widths, D: int, device):
        bases, base = [], 0
        for h in widths:
            bases.append(base)
            base += D * h
        self.D, self.n_rounds, self.window = D, len(widths), base
        self.rounds = torch.tensor(
            [[o % D, h, b] for o, h, b in zip(offsets, widths, bases)],
            dtype=torch.int32, device=device)
        self.reset()
        _live_cards.add(self)

    def reset(self) -> None:
        self.seq = torch.zeros(2 * self.n_rounds * self.D + 2,
                               dtype=torch.int64, device=self.rounds.device)
        self.totals = [0, 0, 0, 0]

    def launch(self, lib, x, pack, unpack, halo, win, n_own: int, Sl: int,
               Hs: int, tc: int, tw: int, mode: str, one_by_one: bool,
               flush_local: bool) -> torch.Tensor:
        """One launch of the kernel on these counters; returns its status
        (n_rounds * D * 2 counts, then the error word)."""
        dev = self.rounds.device
        key = (dev, tc, tw)
        if key not in _caps:
            with torch.cuda.device(dev):
                _caps[key] = lib.rdma_shift_max_ranks(tc, tw)
        if self.D > _caps[key]:
            raise RuntimeError(
                f"rdma_cyclic_shift: {self.D} ranks need {self.D} co-resident "
                f"thread blocks; this card holds {_caps[key]} — use fewer "
                "ranks (num_ranks)")
        status = torch.empty(2 * self.n_rounds * self.D + 1,
                             dtype=torch.int32, device=dev)
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        err = lib.rdma_exchange(
            x.data_ptr(), ptr(pack), ptr(unpack), ptr(halo), win.data_ptr(),
            self.rounds.data_ptr(), self.seq.data_ptr(), status.data_ptr(),
            (ctypes.c_ulonglong * 4)(*self.totals), n_own, self.D,
            self.n_rounds, Sl, Hs, tc, tw, int(mode == "get"),
            int(bool(one_by_one)), int(bool(flush_local)),
            cuda_build.stream_ptr(dev))
        if err:
            self.reset()
        cuda_build.check(err, "rdma_cyclic_shift")
        self.totals[1 if one_by_one else 0] += 1
        self.totals[2] += int(mode == "get")
        self.totals[3] += 1
        rdma_cyclic_shift.launches += 1
        return status


def _check_args(buf, offset, mode) -> int:
    if buf.dim() != 2 or buf.shape[0] < 1 or buf.shape[1] < 1:
        raise ValueError("rdma_cyclic_shift: buf must be (D, H) with D, H "
                         f">= 1, got {tuple(buf.shape)}")
    if mode not in MODES:
        raise ValueError(f"rdma_cyclic_shift: mode must be one of {MODES}, "
                         f"got {mode!r}")
    return int(offset) % buf.shape[0]


def rdma_shift_launch(
    buf: torch.Tensor, offset: int, mode: str = "put",
    one_by_one: bool = False, flush_local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one shift without waiting for the card.  Returns ``out`` and
    the launch's ``status`` (2 D + 1 int32: the counts, then the error
    word), which :func:`rdma_shift_finish` reads."""
    offset = _check_args(buf, offset, mode)
    D, H = buf.shape
    if buf.device.type == "cpu":
        out, counts = rdma_cyclic_shift_plain(buf, offset, mode, one_by_one,
                                              flush_local)
        return out, torch.cat((counts.reshape(-1), counts.new_zeros(1)))
    what = "rdma_cyclic_shift"
    cuda_build.check_operands(what, (buf.dtype,), buf=buf)
    elem = buf.element_size()
    if elem not in _BITS:
        raise TypeError(f"{what}: elements of {elem} bytes ({buf.dtype}); "
                        "the kernel moves 2, 4 or 8")
    key = (buf.device, D, H, offset)
    card = _shift_cards.get(key)
    if card is None:
        card = _shift_cards[key] = _Card([offset], [H], D, buf.device)
    out = torch.empty_like(buf)
    code = _BITS[elem]
    status = card.launch(cuda_build.library("rdma_shift"), buf, None, None,
                         None, out, H, 0, 0, code, code, mode, one_by_one,
                         flush_local)
    return out, status


def rdma_shift_finish(statuses: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Wait for the launches that returned ``statuses`` (one host sync for
    all of them), raise if a rank's wait outlasted the watchdog, and return
    each launch's counts (n_rounds * D, 2)."""
    for err in torch.stack([s[-1] for s in statuses]).tolist():
        if err:
            for card in list(_live_cards):
                card.reset()
            waited = WAITED_FOR.get(err, f"code {err}")
            raise RuntimeError(
                f"rdma_cyclic_shift: a rank waited for {waited} past the "
                "watchdog; the ranks' protocol is broken")
    return [s[:-1].reshape(-1, 2) for s in statuses]


def rdma_cyclic_shift(
    buf: torch.Tensor, offset: int, mode: str = "put",
    one_by_one: bool = False, flush_local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move row ``d`` of ``buf`` (D, H) to row ``(d + offset) % D``; K4 on
    the card, as one round with no pack and no unpack.  Returns ``(out,
    counts)``; raises when the card cannot hold D co-resident blocks and
    when a rank's wait times out."""
    out, status = rdma_shift_launch(buf, offset, mode, one_by_one,
                                    flush_local)
    return out, rdma_shift_finish([status])[0]


rdma_cyclic_shift.launches = 0


class ExchangeRounds:
    """The round tables of one neighbour plan on one device (field names of
    :class:`schwarz_tpu_torch.parallel.neighbor_exchange.NeighborPlan`, as
    int64 / bool tensors), and, built at the first launch on a card and
    kept, K4's: the send tables of all rounds as one int32 table, one int32
    unpack table (an own-block offset, or ``-(1 + window position)`` for a
    slot that crosses ranks), the receive windows and the sequence words."""

    def __init__(self, send_idx: Sequence[torch.Tensor], offsets,
                 recv_round: torch.Tensor, recv_pos: torch.Tensor,
                 local_src: torch.Tensor, is_local: torch.Tensor,
                 n_ranks: int, max_h: int):
        self.send_idx = list(send_idx)
        self.offsets = [int(o) for o in offsets]
        self.recv_round, self.recv_pos = recv_round, recv_pos
        self.local_src, self.is_local = local_src, is_local
        self.n_ranks, self.max_h = int(n_ranks), int(max_h)
        self._card: Optional[_Card] = None

    def _card_tables(self) -> _Card:
        if self._card is None:
            D, dev = self.n_ranks, self.recv_round.device
            widths = [t.shape[1] for t in self.send_idx]
            card = _Card(self.offsets, widths, D, dev)
            self.pack = torch.cat([t.reshape(-1) for t in self.send_idx]).to(
                torch.int32)
            S = self.recv_round.shape[0]
            rounds = card.rounds.to(torch.int64)
            k = torch.clamp(self.recv_round, max=card.n_rounds - 1)
            rank_of = (torch.arange(S, device=dev) // (S // D))[:, None]
            pos = rounds[k, 2] + rank_of * rounds[k, 1] + self.recv_pos
            self.unpack = torch.where(self.is_local, self.local_src,
                                      -1 - pos).to(torch.int32).contiguous()
            # one byte buffer serves every halo type (at most 8 bytes)
            self.windows = torch.empty(8 * card.window, dtype=torch.uint8,
                                       device=dev)
            self._card = card
        return self._card


def exchange_rounds_plain(
    x_own: torch.Tensor, rounds: ExchangeRounds,
    halo_dtype: Optional[torch.dtype],
    shift: Callable[[torch.Tensor, int], torch.Tensor],
) -> torch.Tensor:
    """The rounds as PyTorch ops: per round a pack gather and ``shift``
    (one cyclic shift of the (D, H_k) buffers), then the unpack gather.
    Values that cross ranks travel in ``halo_dtype``; slots owned by the
    same rank are read from its own block, unrounded.  Returns
    ``halo_vals`` (S, H) in the type of ``x_own``."""
    S, r_int = x_own.shape
    D = rounds.n_ranks
    flat = x_own.reshape(D, (S // D) * r_int)       # one row per rank
    send = flat.to(halo_dtype) if halo_dtype is not None else flat
    # received buffers, padded to a common length; extra zero plane for
    # local slots
    bufs = torch.zeros((len(rounds.offsets) + 1, D, rounds.max_h),
                       dtype=send.dtype, device=x_own.device)
    for k, r in enumerate(rounds.offsets):
        got = shift(torch.gather(send, 1, rounds.send_idx[k]), r)
        bufs[k, :, : got.shape[1]] = got
    rank_of = (torch.arange(S, device=x_own.device) // (S // D))[:, None]
    remote = bufs[rounds.recv_round, rank_of, rounds.recv_pos].to(
        x_own.dtype)
    local = flat[rank_of, rounds.local_src]
    return torch.where(rounds.is_local, local, remote)


def rdma_exchange_plain(
    x_own: torch.Tensor, rounds: ExchangeRounds,
    halo_dtype: Optional[torch.dtype] = None, mode: str = "put",
    one_by_one: bool = False, flush_local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exchange as the ``rdma`` transport did it before K4 fused it:
    pack gathers, one plain shift per round, the unpack.  Returns
    ``halo_vals`` (S, H) and the counts (n_rounds, D, 2) by formula."""
    counts = []

    def shift(buf, r):
        out, c = rdma_cyclic_shift_plain(buf, r, mode, one_by_one,
                                         flush_local)
        counts.append(c)
        return out

    halo = exchange_rounds_plain(x_own, rounds, halo_dtype, shift)
    return halo, torch.stack(counts)


def rdma_exchange_launch(
    x_own: torch.Tensor, rounds: ExchangeRounds,
    halo_dtype: Optional[torch.dtype] = None, mode: str = "put",
    one_by_one: bool = False, flush_local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one whole exchange (every round, pack and unpack) without
    waiting for the card.  Returns ``halo_vals`` (S, H) and the launch's
    status (n_rounds * D * 2 counts, then the error word), which
    :func:`rdma_shift_finish` reads.  K4's one launch per exchange."""
    what = "rdma_exchange"
    if mode not in MODES:
        raise ValueError(f"{what}: mode must be one of {MODES}, got {mode!r}")
    S, r_int = x_own.shape
    if S % rounds.n_ranks or rounds.recv_round.shape[0] != S:
        raise ValueError(f"{what}: x_own has {S} subdomains; the plan has "
                         f"{rounds.recv_round.shape[0]} on {rounds.n_ranks} "
                         "ranks")
    if x_own.device.type == "cpu":
        halo, counts = rdma_exchange_plain(x_own, rounds, halo_dtype, mode,
                                           one_by_one, flush_local)
        return halo, torch.cat((counts.reshape(-1), counts.new_zeros(1)))
    cuda_build.check_operands(what, _COMPUTE, x_own=x_own)
    halo_dtype = halo_dtype or x_own.dtype
    if halo_dtype not in _VALUES:
        raise TypeError(f"{what}: halo_dtype {halo_dtype}; the kernel takes "
                        f"{tuple(_VALUES)}")
    card = rounds._card_tables()
    halo = torch.empty(rounds.is_local.shape, dtype=x_own.dtype,
                       device=x_own.device)
    status = card.launch(
        cuda_build.library("rdma_shift"), x_own, rounds.pack, rounds.unpack,
        halo, rounds.windows, (S // rounds.n_ranks) * r_int,
        S // rounds.n_ranks, halo.shape[1], _VALUES[x_own.dtype],
        _VALUES[halo_dtype], mode, one_by_one, flush_local)
    return halo, status


def rdma_exchange(
    x_own: torch.Tensor, rounds: ExchangeRounds,
    halo_dtype: Optional[torch.dtype] = None, mode: str = "put",
    one_by_one: bool = False, flush_local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One whole exchange, waited for: ``halo_vals`` (S, H) and the counts
    (n_rounds, D, 2)."""
    halo, status = rdma_exchange_launch(x_own, rounds, halo_dtype, mode,
                                        one_by_one, flush_local)
    counts = rdma_shift_finish([status])[0]
    return halo, counts.reshape(len(rounds.offsets), rounds.n_ranks, 2)
