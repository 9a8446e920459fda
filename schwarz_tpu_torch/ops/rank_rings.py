"""The message rings of the free-running kernels (K5, K6, K7) in a window,
and the protocol of one launch, in one process or across the processes of a
mesh.

A kernel's window holds, for the process's Dl ranks, ``ND`` rings (one per
direction or colour) of M slots of ``slot`` floats, then the (Dl, ND, M)
64-bit sequence words, the (Dl, ND) 32-bit ack counters, the error word
(process 0's is the group's) and the longest wait in ns
(``csrc/async_common.cuh`` ``RankRings``).  In one process the window is a
:class:`~schwarz_tpu_torch.parallel.mesh.LocalWindow`, built once per kernel,
device and size; across processes it is the mesh's CUDA IPC window
(:meth:`~schwarz_tpu_torch.parallel.mesh.Mesh.window`), built once per mesh
and size, in every process in the same order.

One launch (:func:`launch_rounds`): the process zeroes its own sequence
words, acks and error word (stream-ordered), so messages are numbered from 1
in every launch.  Across processes a peer's launch must not read them
before that, nor may a process zero them while a peer's last launch still
reads them: so each process synchronizes its stream and meets the others at
a barrier before it launches, and again after, before it reads the group's
error word, which every process then reads alike and raises on together.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.parallel.mesh import LocalWindow

# the one-process windows, by (kernel, device, size)
_local_windows: dict = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class RingLayout(NamedTuple):
    """Byte offsets of a window's parts; ``nbytes`` its size."""
    seq_off: int
    ack_off: int
    err_off: int
    nbytes: int


def ring_layout(Dl: int, ND: int, M: int, slot: int) -> RingLayout:
    """The window of Dl ranks of ``ND`` rings of M slots of ``slot``
    floats."""
    # the words that ranks spin on start a fresh 256-byte line after the
    # slots, as in one process, where they are an allocation of their own
    seq_off = _round_up(4 * Dl * ND * M * slot, 256)
    ack_off = seq_off + 8 * Dl * ND * M
    err_off = _round_up(ack_off + 4 * Dl * ND, 8)
    return RingLayout(seq_off, ack_off, err_off, err_off + 16)


def launch_rounds(kind: str, device, mesh, layout: RingLayout,
                  launch: Callable[..., int]) -> Tuple[int, int]:
    """One launch of a free-running kernel: ``launch(table, own, seq_off,
    ack_off, err_off)`` makes it, given the address of the (P,) table of
    windows (None in one process, where the kernel reads no table), of
    this process's window and the byte offsets of its words, and returns
    the C entry point's error.  Returns the group's error word (0 when no
    wait timed out; the same in every process) and this process's longest
    wait in ns (0 in one process, where it is not kept)."""
    if mesh is None:
        key = (kind, torch.device(device), layout.nbytes)
        if key not in _local_windows:
            _local_windows[key] = LocalWindow(layout.nbytes, device)
        w = _local_windows[key]
        w.zero(layout.seq_off, layout.nbytes - layout.seq_off)
        cuda_build.check(launch(None, w.ptr, layout.seq_off, layout.ack_off,
                                layout.err_off), kind)
        err = int.from_bytes(w.read(0, layout.err_off, 4), "little",
                             signed=True)
        return err, 0
    key = (kind, layout.nbytes)
    if key not in mesh.windows:
        mesh.windows[key] = mesh.window(layout.nbytes)
    w = mesh.windows[key]
    w.zero(layout.seq_off, layout.nbytes - layout.seq_off)
    stream = torch.cuda.current_stream(device)
    stream.synchronize()
    mesh.barrier()
    cuda_build.check(launch(w.table.data_ptr(), w.ptr, layout.seq_off,
                            layout.ack_off, layout.err_off), kind)
    stream.synchronize()
    mesh.barrier()
    err = int.from_bytes(w.read(0, layout.err_off, 4), "little", signed=True)
    longest = int.from_bytes(
        w.read(mesh.process_index, layout.err_off + 8, 8), "little")
    return err, longest
