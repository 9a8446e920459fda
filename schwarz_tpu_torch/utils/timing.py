"""Per-stage timing instrument (a copy of ``schwarz_tpu/utils/timing.py``).

Reference C29: the ``MEASURE_ELAPSED_FUNC_TIME`` macro (settings.hpp:508-523)
wraps the five solver-loop stages with steady_clock and accumulates samples keyed
by (id, rank, name); ``write_timings`` then derives total/avg/min/med/max per
stage (bench_base.hpp:219-273).

``RASolver.run_instrumented`` times each stage on the host clock with the
device synchronized inside the timed block, so a sample is the stage's time
and not the time to enqueue it; ``run()`` reports whole-solve wall time only.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

# the reference's five timed regions (schwarz_base.cpp:393-450)
STAGES = (
    "boundary_exchange",
    "boundary_update",
    "convergence_check",
    "local_solve",
    "expand_local_vec",
)


class StageTimer:
    """Accumulates per-stage wall-time samples across iterations."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self._t0 = None
        self._stage = None

    def start(self, stage: str):
        self._stage = stage
        self._t0 = time.perf_counter()

    def stop(self):
        self.samples[self._stage].append(time.perf_counter() - self._t0)
        self._stage = None

    def time(self, stage: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                timer.start(stage)

            def __exit__(self, *a):
                timer.stop()

        return _Ctx()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {total, avg, min, med, max, count}} (bench_base.hpp:249-265)."""
        out = {}
        for stage, vals in self.samples.items():
            a = np.asarray(vals)
            out[stage] = {
                "total": float(a.sum()),
                "avg": float(a.mean()),
                "min": float(a.min()),
                "med": float(np.median(a)),
                "max": float(a.max()),
                "count": int(a.size),
            }
        return out
