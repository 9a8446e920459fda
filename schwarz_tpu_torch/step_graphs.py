"""The synchronous solver's outer iteration replayed as two CUDA graphs.

An outer iteration of :class:`~schwarz_tpu_torch.ras.RASolver` is a fixed
sequence of a hundred-odd small launches (K1, K2, K3 and PyTorch's own
kernels) around one host read, its flags.  Issued one by one from Python,
each costs 10-20 us of host time against 2-5 us of device time, so the card
waits on the host.  Here the sequence before the read (``check``) and the
sequence after it on a pass that solves (``advance``) are each captured
once as a ``torch.cuda.CUDAGraph`` and then replayed: the same kernels with
the same arguments on the same buffers, so every result equals the eager
step's bit for bit.

:func:`capturable` is the gate, decided once per solver from what it can
observe: the step's only host read must be its flags.  :class:`StepGraphs`
captures at the first pass that solves, right after running that pass
eagerly on the capture stream as its warm-up, and replays from then on.
The kernel wrappers' launch counters move at a replay by what the capture
recorded, so they count what the card ran; :func:`step_graph_replay`
counts the replays themselves, by half.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from schwarz_tpu_torch.config import HaloStrategy, Settings
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv
from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve
from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext
from schwarz_tpu_torch.utils.timing import span

# the counted kernel wrappers an outer iteration can call under the gate;
# a wrapper that joins the step's path joins here
COUNTED = (dia_spmv, assemble_x_ext, fused_cg_solve)


def capturable(settings: Settings, device: torch.device, mesh,
               local_reads_host: bool) -> bool:
    """Whether an outer iteration's one host read is its flags, so that the
    halves around it replay as CUDA graphs: a CUDA device; one process
    (``mesh`` None or of one process: across processes the collectives
    pass through the host); no coarse CG (it reads the host each CG
    iteration); no ``rdma`` exchange (K4's status words); no halo refreshed
    every ``staleness`` > 1 iterations (a branch on the iteration); no
    inner budget that changes with the iteration
    (``reset_local_crit_iter``); and a local solve that reads nothing
    (``local_reads_host`` False: K3 or a direct factor, not the unfused CG
    or GMRES, which test their residuals on the host)."""
    s = settings
    return (device.type == "cuda"
            and (mesh is None or mesh.num_processes == 1)
            and not (s.two_level and s.coarse_solver == "cg")
            and s.comm.strategy != HaloStrategy.rdma
            and not (s.comm.onesided and s.comm.staleness > 1)
            and not (s.reset_local_crit_iter >= 0 and s.local_max_iters > 0)
            and not local_reads_host)


Counts = List[Tuple[int, Dict]]


def _counts() -> Counts:
    return [(fn.launches, dict(getattr(fn, "launches_by", {})))
            for fn in COUNTED]


def _restore(counts: Counts) -> None:
    for fn, (n, by) in zip(COUNTED, counts):
        fn.launches = n
        if hasattr(fn, "launches_by"):
            fn.launches_by.clear()
            fn.launches_by.update(by)


class _Graph(NamedTuple):
    """One captured half: its name, the graph and the wrappers' launches
    it holds (``(launches, launches_by)`` by wrapper, as :data:`COUNTED`)."""

    name: str
    graph: torch.cuda.CUDAGraph
    launches: Counts


def step_graph_replay(g: _Graph) -> None:
    """Replay one captured half of an outer iteration on the current
    stream, counted in ``step_graph_replay.launches`` and by half
    (``check``, ``advance``) in ``launches_by``; the kernel wrappers'
    counters gain the launches the half holds."""
    g.graph.replay()
    step_graph_replay.launches += 1
    halves = step_graph_replay.launches_by
    halves[g.name] = halves.get(g.name, 0) + 1
    for fn, (n, by) in zip(COUNTED, g.launches):
        fn.launches += n
        for k, v in by.items():
            fn.launches_by[k] = fn.launches_by.get(k, 0) + v


step_graph_replay.launches = 0
step_graph_replay.launches_by = {}   # 'check', 'advance'


class StepGraphs:
    """The two halves of one solver's outer iteration, captured once on
    the solver's state buffers and replayed.  Until :attr:`ready`, the
    solver runs its step eagerly under :meth:`warming` (on the capture
    stream, so that the kernels' first-call queries, cuBLAS's workspace
    and the allocator settle there) and hands a pass that solved to
    :meth:`capture`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ready = False
        self._stream = None
        self.out: Dict[str, torch.Tensor] = {}

    @contextlib.contextmanager
    def warming(self):
        """Run the enclosed eager step on the capture stream, ordered
        after and before the current stream's work."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            current.wait_stream(self._stream)

    def _capture(self, name: str, fn: Callable,
                 pool) -> Tuple[_Graph, object]:
        """Capture ``fn()``; the wrappers' counters it moved (nothing ran)
        go back and are kept as the graph's launches."""
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=self._stream):
                out = fn()
            after = _counts()
        finally:
            _restore(before)
        held = [(a - b, {k: v - bb.get(k, 0) for k, v in ab.items()
                         if v != bb.get(k, 0)})
                for (b, bb), (a, ab) in zip(before, after)]
        return _Graph(name, graph, held), out

    def capture(self, check: Callable[[], Dict[str, torch.Tensor]],
                advance: Callable[[Dict[str, torch.Tensor]], None]) -> None:
        """Capture ``check()`` and ``advance(out)`` on ``out``, the tensors
        ``check`` returns, which stay the graphs' own (:attr:`out`).
        Nothing runs: the state stays as the warm-up pass left it."""
        with span("step.capture"):
            pool = torch.cuda.graph_pool_handle()
            self._check, self.out = self._capture("check", check, pool)
            self._advance, _ = self._capture(
                "advance", lambda: advance(self.out), pool)
        self.ready = True

    def check(self) -> Dict[str, torch.Tensor]:
        """Replay ``check``; returns its outputs."""
        with span("step.check"):
            step_graph_replay(self._check)
        return self.out

    def advance(self) -> None:
        """Replay ``advance``."""
        with span("step.advance"):
            step_graph_replay(self._advance)
