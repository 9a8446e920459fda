"""What one run read, handed to every metric's reader (``metrics/<name>.py``
``read(ctx)``).  All of it is plain data: the harness's own spans around
each call into the program, the program's launch counters, the plan's
shapes and tables, and the reduced device trace."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Solve:
    """One request, on the host clock around the harness's calls."""

    row: int              # the request's row of the pool
    wall_s: float         # set_rhs and the entry, to the solution on host
    set_rhs_s: float
    entry_s: float        # the entry call, result assembly included
    loop_s: float         # the program's own loop time (solve_time_s)
    iters: int            # RASResult.iters
    converged: bool       # the program's own flag (not what is judged)
    # the program's last global residual-history entry (FGMRES: its
    # residual estimate; printed beside the reference's, never judged)
    hist_last: float = float("nan")


@dataclasses.dataclass
class Readings:
    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    platform: str                     # "gpu" or, in the CPU tests, "cpu"
    setup_s: float                    # process start to the first timed solve
    setup_split: Dict[str, float]     # seconds by set-up step
    window_s: float                   # first timed solve's start to last's end
    solves: List[Solve]               # the window's, in order
    # launch counters of the program's kernel wrappers over the window:
    # {wrapper: {"launches": n, "launches_by": {operand key: n}}}
    counters: Dict[str, Dict[str, Any]]
    # S, R_int, R_rows, R_ext, dtype, halo_strategy, and the explicit
    # inverse's shape when the locals apply one
    shapes: Dict[str, Any]
    # numpy copies of plan tables a kernel reads (K2: ext_segs, ext_first)
    tables: Dict[str, Any]
    # the traced stretch (devtrace.profile_solves, plus "counters" over it
    # and "solves"); None without --trace 1
    profile: Optional[Dict[str, Any]] = None
    # instrumented solves: {"stage_timings", "loop_s", "iters"} each;
    # None where the configuration names no instrumented entry
    instrumented: Optional[List[Dict[str, Any]]] = None
    # the mesh layer over the window: the delta of process 0's
    # ``Mesh.stats`` (calls, seconds, wait_seconds, bytes); None in a run
    # of one process
    mesh: Optional[Dict[str, float]] = None
