"""Per-stage timing instrument (a copy of ``schwarz_tpu/utils/timing.py``),
and the port's own spans and counters.

Reference C29: the ``MEASURE_ELAPSED_FUNC_TIME`` macro (settings.hpp:508-523)
wraps the five solver-loop stages with steady_clock and accumulates samples keyed
by (id, rank, name); ``write_timings`` then derives total/avg/min/med/max per
stage (bench_base.hpp:219-273).

``RASolver.run_instrumented`` times each stage on the host clock with the
device synchronized inside the timed block, so a sample is the stage's time
and not the time to enqueue it; ``run()`` reports whole-solve wall time only.

The spans (:func:`span`, :func:`recording`, :func:`spans`) mark each layer
of the port where its work happens, from set-up and the entry points down
to the outer loop's stages, without a synchronize: off by default, on they
are kept in memory and, while a profiler runs, named ``schwarz.<name>`` in
``torch.profiler``'s trace.  The counters (:func:`count`, :func:`counts`) are always on;
``host_reads`` counts the solve's reads that wait for the device, by site.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

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


# --------------------------------------------------------------- spans --
# The program's own spans: each layer of a solve (set-up, the entry point,
# the outer loop, the stages) marks where its work happens.  Off, ``span``
# returns one shared object whose ``with`` does nothing: no clock is read
# and torch is not called.  On, a span is appended to an in-memory list on
# ``time.perf_counter_ns`` and, while a profiler runs, entered as
# ``torch.profiler.record_function("schwarz." + name)``, so that the same
# span lies on the device trace's host timeline, on the profiler's own
# clock.  Without a profiler ``record_function`` records nothing and costs
# some 27 us a span on an H100 machine's host, so it is left out then.

PREFIX = "schwarz."


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int     # index of the enclosing span, -1 at the top
    solve: int      # the request's id (new_request); 0 outside any request


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording = False
_spans: List[list] = []
_open: List[tuple] = []     # (index, record) of each open span
_solve = 0                  # the latest request id
_record_function = None
_profiler_enabled = None


class _On:
    __slots__ = ("name", "solve", "rec", "rf")

    def __init__(self, name: str, solve: int):
        self.name = name
        self.solve = solve

    def __enter__(self):
        global _record_function, _profiler_enabled
        if _record_function is None:
            from torch.autograd import _profiler_enabled
            from torch.profiler import record_function as _record_function
        name = self.name
        if _open:
            parent, up = _open[-1]
            solve = up[4]
        else:
            parent, solve = -1, self.solve
        self.rec = [name, 0, 0, parent, solve]
        _open.append((len(_spans), self.rec))
        _spans.append(self.rec)
        self.rf = None
        if _profiler_enabled():
            self.rf = _record_function(PREFIX + name)
            self.rf.__enter__()
        self.rec[1] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if _open and _open[-1][1] is self.rec:
            _open.pop()
        return False


def span(name: str, solve: int = 0):
    """The span ``name`` as a context manager: recorded when
    :func:`recording` is on, else a shared object that does nothing.  A
    span at the top takes the request id ``solve``; a nested one its
    parent's."""
    return _On(name, solve) if _recording else _OFF


def new_request() -> int:
    """A new request id: the caller passes it to the spans at the top of
    one request (a new right-hand side and the solve of it)."""
    global _solve
    _solve += 1
    return _solve


def spanned(name: str):
    """Decorator: the whole call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def recording(on: bool) -> bool:
    """Turn the spans on or off; returns the previous setting."""
    global _recording
    prev, _recording = _recording, bool(on)
    return prev


def spans() -> List[Span]:
    """A snapshot of the recorded spans, in the order they started; a span
    still open has ``end_ns`` 0."""
    return [Span(*s) for s in _spans]


def clear_spans() -> None:
    """Drop the recorded spans and start the request ids again from 1 (an
    open span's ``with`` still closes safely; its record is gone)."""
    global _solve
    del _spans[:]
    del _open[:]
    _solve = 0


# ------------------------------------------------------------ counters --
# Counts by site, always on: a plain dict increment, as the kernel
# wrappers' launch counters are.  ``host_reads`` counts each read on the
# synchronous solve's path where the host waits for the device (``bool``,
# ``.item()``, ``.tolist()``, ``float`` or ``.cpu()`` of a device tensor),
# by the site that makes it.

_counts: Dict[str, Dict[str, int]] = {}
HOST_READS = "host_reads"


def count(counter: str, site: str, n: int = 1) -> None:
    """Add ``n`` to ``counter`` at ``site``."""
    by = _counts.get(counter)
    if by is None:
        by = _counts[counter] = {}
    by[site] = by.get(site, 0) + n


def counts() -> Dict[str, Dict[str, int]]:
    """A snapshot of every counter: ``{counter: {site: n}}``."""
    return {k: dict(v) for k, v in _counts.items()}
