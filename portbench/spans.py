"""Readers of the program's own spans and host reads, on plain data: what
a cell's traced run reads once it records them (the CPU tests feed them
data of their own).

- ``host_reads_per_iter``: the window's ``host_reads`` over its outer
  iterations;
- ``fixed_cost_s``: seconds a profiled solve spends in ``set_rhs``,
  ``prepare`` and ``assemble_result``;
- ``local_solve_device_busy``: the device seconds launched inside
  ``schwarz.local_solve`` (the profiler's ``key_averages``) over those
  spans' host seconds, in %;
- ``eigensolve_s``: the set-up's ``eigensolve`` spans;
- ``idle_by_span``: the device's idle seconds in a profiled stretch by
  the innermost ``schwarz.`` span at each idle gap's middle;
- ``copies_by_op``: the device-to-host copies in a stretch by the host
  operation that made them, to hold against the ``host_reads`` counted
  there.
"""

from __future__ import annotations

import statistics
from collections import Counter, defaultdict

from portbench import devtrace

PREFIX = "schwarz."          # the program's spans (utils/timing.py PREFIX)
OUTSIDE = "outside the program"
FIXED = ("set_rhs", "prepare", "assemble_result")


def _seconds(span) -> float:
    return (span.end_ns - span.start_ns) * 1e-9


def idle_by_span(gaps, host) -> dict:
    """Idle seconds by the innermost ``schwarz.`` host event running at
    each gap's middle; :data:`OUTSIDE` where none runs."""
    named = devtrace.label_gaps(
        gaps, [e for e in host if e[0].startswith(PREFIX)])
    out = defaultdict(float)
    for name, s in named.items():
        out[name if name.startswith(PREFIX) else OUTSIDE] += s
    return dict(out)


def per_solve(spans, names) -> dict:
    """Seconds in the spans ``names`` by solve id, requests only."""
    out = defaultdict(float)
    for s in spans:
        if s.solve and s.name in names:
            out[s.solve] += _seconds(s)
    return dict(out)


def fixed_cost_s(spans):
    per = per_solve(spans, FIXED)
    return statistics.mean(per.values()) if per else None


def local_solve_device_busy(spans, ops):
    host = sum(per_solve(spans, ("local_solve",)).values())
    dev = ops.get(PREFIX + "local_solve", (0, 0.0))[1]
    return 100 * dev / host if host > 0 and dev > 0 else None


def eigensolve_s(spans):
    t = [_seconds(s) for s in spans if s.name == "eigensolve" and not s.solve]
    return sum(t) if t else None


def host_reads_per_iter(reads: int, iters: int):
    return reads / iters if reads and iters else None


def copies_by_op(chains) -> Counter:
    """Device-to-host copies by ``(innermost schwarz span, outermost
    operator below it)``; ``chains`` holds, for each copy, the names from
    the operator that launched it up through its enclosing events."""
    out = Counter()
    for chain in chains:
        span, op = OUTSIDE, chain[0] if chain else "?"
        for name in chain:
            if name.startswith(PREFIX):
                span = name
                break
            if not name.startswith(devtrace.LABEL):
                op = name
        out[(span, op)] += 1
    return out
