"""The rank axis across processes: the port of
``schwarz_tpu/parallel/mesh.py``, with the roles that
``jax.distributed.initialize`` and ``multihost_utils.process_allgather``
play in a multi-controller run.

The reference binds one subdomain group per MPI rank (``num_subdomains =
comm_size``, initialization.cpp:74) and detects which ranks share a node
(utils.cpp:41-78).  A :class:`Mesh` deals D ranks to P processes, D / P
consecutive ranks each (``process_of[d] = d // (D / P)``); a rank owns
S / D consecutive subdomains, so a process holds S / P consecutive
subdomains, batched on its device.  Within a process the ranks stay a
leading axis of that batch, as with ``num_ranks`` on one card; across
processes the collectives below go through the default
``torch.distributed`` process group, whose ranks are the processes:

  - :meth:`Mesh.all_gather`: the rank blocks of every process, tiled along
    dim 0 (``jax.lax.all_gather(..., tiled=True)``);
  - :meth:`Mesh.psum`: the sum over processes, the same bits on every
    process (gathered, then summed in process order);
  - :meth:`Mesh.shift`: the global ``torch.roll`` over the rank axis (the
    JAX package's ``ppermute`` by a cyclic offset), its cross-process parts
    sent to and received from the at most two processes the offset reaches;
  - :meth:`Mesh.process_allgather`: a process block gathered to the host;
  - :meth:`Mesh.barrier`: every process has reached this point;
  - :meth:`Mesh.window`: a device buffer in every process, each mapped into
    every other through CUDA IPC (``csrc/peer_window.cu``), the role of
    ``MPI_Win_create``: the one-sided exchange (K4) and the free-running
    kernels (K5-K7) reach a peer process's ranks through it.

Transport.  The group is gloo (``initialize``'s default): NCCL refuses two
ranks on one GPU, and one card may hold every process.  Device tensors are
staged through pinned host tensors explicitly, copied to the host before
the collective and back after it: compute never leaves the device, only
the exchanged values cross the host.  A group on another backend (NCCL,
processes on distinct cards) takes device tensors as they are; that path
is written but not verified.  With one process a mesh makes no collective
at all, and the solver takes its single-process path.

:func:`launch` starts the processes of a group on one host (the role of
``mpirun``): the tests' CPU groups and the card's multi-process runs.

``stats`` counts the collectives, the bytes they send and the host seconds
spent in them, staging included (``seconds``), and of those the seconds
spent waiting for the device's queued work before the copy to the host
(``wait_seconds``): the mesh layer's cost per outer iteration.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import os
import socket
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

SUBD_AXIS = "subd"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """Join the process group (``jax.distributed.initialize``):
    ``coordinator_address`` is ``host:port`` of process 0, where the group
    meets.  A collective that waits longer than ``timeout_s`` for a peer
    raises, so a process that failed does not hang the others for good."""
    dist.init_process_group(
        backend or "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D ranks over P processes (see the module's docstring)."""

    num_ranks: int
    num_processes: int = 1
    process_index: int = 0
    device: torch.device = torch.device("cpu")
    stats: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "seconds": 0.0,
                                 "wait_seconds": 0.0, "bytes": 0},
        compare=False)
    # the kernels' windows on this mesh, by the caller's key (built once,
    # every process in the same order)
    windows: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        D, P = self.num_ranks, self.num_processes
        if D < 1 or P < 1 or D % P:
            raise ValueError(
                f"a mesh of {D} ranks cannot be dealt to {P} processes")
        if not 0 <= self.process_index < P:
            raise ValueError(f"process_index {self.process_index} outside "
                             f"{P} processes")

    @property
    def ranks_per_process(self) -> int:
        return self.num_ranks // self.num_processes

    @property
    def process_of(self) -> Tuple[int, ...]:
        """(D,) rank -> process."""
        return tuple(d // self.ranks_per_process
                     for d in range(self.num_ranks))

    def block(self, n: int) -> slice:
        """This process's share of an axis of ``n`` entries dealt in rank
        order (subdomains, or rows of a per-subdomain array)."""
        P = self.num_processes
        if n % P:
            raise ValueError(f"{n} entries cannot be dealt to {P} processes")
        k = n // P
        return slice(self.process_index * k, (self.process_index + 1) * k)

    # ------------------------------------------------------------ transport --
    def _staged(self) -> bool:
        return dist.get_backend() == "gloo"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cpu" or not self._staged():
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        t0 = time.perf_counter()
        torch.cuda.current_stream(t.device).synchronize()
        self.stats["wait_seconds"] += time.perf_counter() - t0
        h.copy_(t)
        return h

    def _empty(self, shape, dtype, like: torch.Tensor) -> torch.Tensor:
        if like.device.type == "cpu" or not self._staged():
            return torch.empty(shape, dtype=dtype, device=like.device)
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _to_device(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device, non_blocking=True)

    def _count(self, t0: float, nbytes: int) -> None:
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["bytes"] += nbytes

    # ---------------------------------------------------------- collectives --
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` (the same shape everywhere), in process
        order, tiled along dim 0."""
        P = self.num_processes
        if P == 1:
            return t
        t0 = time.perf_counter()
        h = self._to_host(t)
        # the bytes travel as they are: no arithmetic, any dtype
        flat = h.reshape(-1).view(torch.uint8)
        out = self._empty((P, flat.numel()), torch.uint8, h)
        dist.all_gather(list(out.unbind(0)), flat)
        g = out.view(t.dtype).reshape((P * t.shape[0],) + tuple(t.shape[1:]))
        g = self._to_device(g, t)
        self._count(t0, out.numel())
        return g

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over processes, added in process order, so every
        process holds the same bits (a host decision taken on it agrees)."""
        if self.num_processes == 1:
            return t
        g = self.all_gather(t.reshape((1,) + tuple(t.shape)))
        return torch.sum(g, dim=0)

    def process_allgather(self, t: torch.Tensor) -> np.ndarray:
        """:meth:`all_gather` of a process block, on the host."""
        return self.all_gather(t).cpu().numpy()

    def barrier(self) -> None:
        """Return once every process of the group has called it."""
        if self.num_processes > 1:
            dist.barrier()

    def window(self, nbytes: int) -> "PeerWindow":
        """A zeroed device buffer of ``nbytes`` in every process, each
        mapped into every other (a collective: every process calls it with
        the same ``nbytes``).  One process takes a :class:`LocalWindow`
        instead, which makes no IPC call."""
        return PeerWindow(self, nbytes)

    def shift(self, buf: torch.Tensor, offset: int) -> torch.Tensor:
        """This process's rows of ``torch.roll(G, offset, 0)``, where ``G``
        (D, ...) is every process's ``buf`` (D / P, ...) in process order.
        Rows that stay in the process are copied; the others go to and
        come from the at most two processes the offset reaches, in one
        batch of point-to-point transfers."""
        D, Dl, p = self.num_ranks, self.ranks_per_process, self.process_index
        if buf.shape[0] != Dl:
            raise ValueError(f"shift: {buf.shape[0]} rows, the process has "
                             f"{Dl} ranks")
        if self.num_processes == 1:
            return torch.roll(buf, offset, 0)
        t0 = time.perf_counter()
        mine = np.arange(p * Dl, (p + 1) * Dl)
        src = (mine - offset) % D           # the row each of mine receives
        dst = (mine + offset) % D           # where each of mine goes
        out = torch.empty_like(buf)
        stay = src // Dl == p
        if stay.any():
            out[torch.from_numpy(np.nonzero(stay)[0]).to(buf.device)] = buf[
                torch.from_numpy(src[stay] - p * Dl).to(buf.device)]
        ops, recvs, nbytes = [], [], 0
        h = None
        for q in sorted(set((dst // Dl).tolist()) - {p}):
            # my rows bound for q, in the order of their places there
            rows = np.nonzero(dst // Dl == q)[0]
            rows = rows[np.argsort(dst[rows])]
            if h is None:
                h = self._to_host(buf)
            piece = h[torch.from_numpy(rows)].contiguous()
            ops.append(dist.P2POp(dist.isend, piece, q))
            nbytes += piece.numel() * piece.element_size()
        for q in sorted(set((src // Dl).tolist()) - {p}):
            rows = np.nonzero(src // Dl == q)[0]
            rows = rows[np.argsort(src[rows])]
            piece = self._empty((len(rows),) + tuple(buf.shape[1:]),
                                buf.dtype, buf)
            ops.append(dist.P2POp(dist.irecv, piece, q))
            recvs.append((rows, piece))
        for req in (dist.batch_isend_irecv(ops) if ops else ()):
            req.wait()
        for rows, piece in recvs:
            out[torch.from_numpy(rows).to(buf.device)] = self._to_device(
                piece, buf)
        self._count(t0, nbytes)
        return out


class LocalWindow:
    """The window of one process (the kernels' windows without a mesh of
    several): a zeroed PyTorch buffer, its table the buffer's own address.
    The interface of :class:`PeerWindow`."""

    def __init__(self, nbytes: int, device):
        self.nbytes = int(nbytes)
        self.buffer = torch.zeros(max(self.nbytes, 8), dtype=torch.uint8,
                                  device=device)
        self.ptr = self.buffer.data_ptr()
        self.addresses = [self.ptr]
        self.table = torch.tensor(self.addresses, dtype=torch.int64,
                                  device=device)

    def zero(self, offset: int, n: int) -> None:
        """Stream-ordered zeroing of this process's bytes [offset, +n)."""
        self.buffer[offset:offset + n].zero_()

    def read(self, q: int, offset: int, n: int) -> bytes:
        """Bytes [offset, +n) of process ``q``'s window (synchronizes)."""
        del q
        return self.buffer[offset:offset + n].cpu().numpy().tobytes()

    def close(self) -> None:
        self.buffer = self.table = None


class PeerWindow:
    """A window across processes (:meth:`Mesh.window`): this process's
    buffer (``cudaMalloc``, not the caching allocator, whose blocks are
    sub-allocated and may not be exportable), and ``table``, a device int64
    (P,) of every process's buffer address as mapped here (its own entry is
    its own pointer: a process cannot open its own handle).  The handles
    travel in one gather over the group.  The buffer lives until
    :meth:`close`, a collective, or the process's end: a process must not
    free memory that a peer still maps, so nothing frees it behind the
    group's back."""

    def __init__(self, mesh: Mesh, nbytes: int):
        from schwarz_tpu_torch.ops import cuda_build

        self.mesh, self.nbytes = mesh, int(nbytes)
        self.device = mesh.device
        lib = self._lib = cuda_build.library("peer_window")
        p = mesh.process_index
        ptr = ctypes.c_ulonglong()
        handle = (ctypes.c_ubyte * 64)()
        with torch.cuda.device(self.device):
            cuda_build.check(lib.peer_window_alloc(
                max(self.nbytes, 8), ctypes.addressof(ptr)), "window alloc")
            self.ptr = ptr.value
            cuda_build.check(lib.peer_window_handle(
                self.ptr, ctypes.addressof(handle)), "window handle")
        handles = mesh.all_gather(torch.tensor(
            list(bytes(handle)), dtype=torch.uint8).reshape(1, 64))
        self.addresses, self._opened = [], []
        with torch.cuda.device(self.device):
            for q in range(mesh.num_processes):
                if q == p:
                    self.addresses.append(self.ptr)
                    continue
                h = (ctypes.c_ubyte * 64)(*handles[q].tolist())
                cuda_build.check(lib.peer_window_open(
                    ctypes.addressof(h), ctypes.addressof(ptr)),
                    f"window open (process {q})")
                self.addresses.append(ptr.value)
                self._opened.append(ptr.value)
        self.table = torch.tensor(self.addresses, dtype=torch.int64,
                                  device=self.device)

    def zero(self, offset: int, n: int) -> None:
        from schwarz_tpu_torch.ops import cuda_build

        cuda_build.check(self._lib.peer_window_zero(
            self.ptr, offset, n, cuda_build.stream_ptr(self.device)),
            "window zero")

    def read(self, q: int, offset: int, n: int) -> bytes:
        from schwarz_tpu_torch.ops import cuda_build

        out = (ctypes.c_ubyte * n)()
        with torch.cuda.device(self.device):
            cuda_build.check(self._lib.peer_window_read(
                self.addresses[q], offset, ctypes.addressof(out), n),
                "window read")
        return bytes(out)

    def close(self) -> None:
        """A collective: no process frees its buffer while a peer still
        maps it, nor unmaps a peer's before the peer's launches ended."""
        if self.table is None:
            return
        from schwarz_tpu_torch.ops import cuda_build

        torch.cuda.synchronize(self.device)
        self.mesh.barrier()
        with torch.cuda.device(self.device):
            for a in self._opened:
                cuda_build.check(self._lib.peer_window_close(a),
                                 "window close")
        self.mesh.barrier()
        with torch.cuda.device(self.device):
            cuda_build.check(self._lib.peer_window_free(self.ptr),
                             "window free")
        self.table, self._opened = None, []


def group_of(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it deals its ranks to more than one process, else None
    (one process: the single-process path)."""
    return mesh if mesh is not None and mesh.num_processes > 1 else None


def gather(mesh: Optional[Mesh], t: torch.Tensor, axis: int = 0
           ) -> np.ndarray:
    """The whole of an array dealt to the processes along ``axis``, on the
    host of every process (the tensor itself without a mesh of several)."""
    if group_of(mesh) is None:
        return t.detach().cpu().numpy()
    g = mesh.process_allgather(t.detach().movedim(axis, 0).contiguous())
    return np.moveaxis(g, 0, axis)


def cut(mesh: Optional[Mesh], a: np.ndarray, axis: int = 0) -> np.ndarray:
    """This process's block of a whole array along ``axis``."""
    if group_of(mesh) is None:
        return a
    sl = [slice(None)] * a.ndim
    sl[axis] = mesh.block(a.shape[axis])
    return a[tuple(sl)]


def write_once(mesh: Optional[Mesh], write) -> None:
    """Call ``write()`` in process 0 alone, then wait until it has (a file
    every process then reads)."""
    if group_of(mesh) is None:
        write()
        return
    if mesh.process_index == 0:
        write()
    mesh.barrier()


def make_mesh(num_ranks: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the default process group (one process when none was
    initialized): ``num_ranks`` ranks, one per process by default, dealt
    to the processes in order.  The device is the caller's, else a CUDA
    device (the process's index modulo the visible cards); there is no
    silent fall back to the CPU."""
    if dist.is_initialized():
        P = dist.get_world_size()
        pid = dist.get_rank()
    else:
        P, pid = 1, 0
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "schwarz_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        device = torch.device("cuda", pid % torch.cuda.device_count())
    return Mesh(num_ranks=P if num_ranks is None else int(num_ranks),
                num_processes=P, process_index=pid,
                device=torch.device(device))


def launch(argv: Sequence[str], nproc: int, log_dir: str,
           timeout_s: float, env: Optional[dict] = None) -> List[str]:
    """Run ``nproc`` processes of ``argv + [pid, nproc, port]`` on this
    host, ``port`` a free localhost port for :func:`initialize`; each
    process's output goes to ``log_dir/log<pid>.txt``.  Returns the logs,
    in process order, once every process exited 0.  The first process to
    fail, or a group outlasting ``timeout_s``, has every process still
    running killed (a peer waiting in a collective would otherwise wait
    out its own timeout), and the call raises with the ends of the
    logs."""
    os.makedirs(log_dir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    paths = [os.path.join(log_dir, f"log{pid}.txt") for pid in range(nproc)]
    procs = []
    try:
        for pid, path in enumerate(paths):
            with open(path, "w") as log:
                procs.append(subprocess.Popen(
                    list(argv) + [str(pid), str(nproc), str(port)],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]        # every one, each time
            if any(rcs) or all(rc == 0 for rc in rcs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for path in paths:
        with open(path, errors="replace") as f:
            logs.append(f.read())
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(
            f"processes exited {rcs} (negative: killed, after {timeout_s} s "
            f"or a peer's failure)\n" + "\n".join(
                f"--- process {pid} (exit {rc}):\n{log[-3000:]}"
                for pid, (rc, log) in enumerate(zip(rcs, logs))))
    return logs
