"""K4: the one-sided cyclic shift of packed halo buffers, a hand-written
CUDA kernel.

Replaces ``schwarz_tpu/parallel/neighbor_exchange.py`` ``_rdma_cyclic_shift``
(:167).  For one round of one offset, given ``buf`` (D, H) whose row ``d``
is what rank ``d`` packed, it returns ``out`` with

    out[(d + offset) % D] = buf[d]

moved as the reference's one-sided transfers move it (put or get, one
transfer per buffer or per element, flush-all or flush-local; source and
protocol: ``csrc/rdma_shift.cu``).  A rank is a thread block of one
cooperative launch; ranks signal each other through counters in device
memory.  The variants move the same data, so the kernel also reports, per
rank, the completion signals it received (1, or H one by one) and the
requests it served (1 in get mode, else 0): ``counts`` (D, 2) int32.

The counters are not kept between launches: the wrapper allocates them
zeroed on the current stream for every launch (a stream-ordered memset).
A rank whose wait outlasts the kernel's watchdog sets an error word, which
:func:`rdma_shift_finish` turns into a ``RuntimeError``.

On a CPU tensor the wrapper takes the plain version below; on a CUDA
tensor it launches the kernel or raises.  Element sizes of 2, 4 and 8
bytes (it moves bits; there is no arithmetic).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from schwarz_tpu_torch.ops import cuda_build

MODES = ("put", "get")
WAITED_FOR = {4: "a request from the rank it serves",
              5: "its source rank's data"}


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
    word), which :func:`rdma_shift_finish` reads.  This is where K4 is
    launched and counted."""
    offset = _check_args(buf, offset, mode)
    D, H = buf.shape
    if buf.device.type == "cpu":
        out, counts = rdma_cyclic_shift_plain(buf, offset, mode, one_by_one,
                                              flush_local)
        return out, torch.cat((counts.reshape(-1), counts.new_zeros(1)))
    what = "rdma_cyclic_shift"
    cuda_build.check_operands(what, (buf.dtype,), buf=buf)
    elem = buf.element_size()
    if elem not in (2, 4, 8):
        raise TypeError(f"{what}: elements of {elem} bytes ({buf.dtype}); "
                        "the kernel moves 2, 4 or 8")
    lib = cuda_build.library("rdma_shift")
    with torch.cuda.device(buf.device):
        cap = lib.rdma_shift_max_ranks(elem)
    if D > cap:
        raise RuntimeError(
            f"{what}: {D} ranks need {D} co-resident thread blocks; this "
            f"card holds {cap} — use fewer ranks (num_ranks)")
    out = torch.empty_like(buf)
    sync = torch.zeros(2 * D, dtype=torch.int32, device=buf.device)
    status = torch.zeros(2 * D + 1, dtype=torch.int32, device=buf.device)
    cuda_build.check(
        lib.rdma_shift(buf.data_ptr(), out.data_ptr(), sync.data_ptr(),
                       status.data_ptr(), D, H, elem, offset,
                       int(mode == "get"), int(bool(one_by_one)),
                       int(bool(flush_local)),
                       cuda_build.stream_ptr(buf.device)),
        what)
    rdma_cyclic_shift.launches += 1
    return out, status


def rdma_shift_finish(statuses: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Wait for the launches that returned ``statuses`` (one host sync for
    all of them), raise if a rank's wait outlasted the watchdog, and return
    each launch's counts (D, 2)."""
    for err in torch.stack([s[-1] for s in statuses]).tolist():
        if err:
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
    the card.  Returns ``(out, counts)``; raises when the card cannot hold
    D co-resident blocks and when a rank's wait times out."""
    out, status = rdma_shift_launch(buf, offset, mode, one_by_one,
                                    flush_local)
    return out, rdma_shift_finish([status])[0]


rdma_cyclic_shift.launches = 0
