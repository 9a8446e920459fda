"""The device trace of a bounded stretch of whole solves, reduced to plain
numbers: device time by kernel name, host operations with the device time
they launched, the device's busy time (the union of its kernel and copy
intervals) within the stretch, and the idle time by what the host was
doing.  Nothing is written to disk; the profiler's records are read in
memory and dropped.

The reduction (:func:`reduce_events`) works on plain tuples ``(name, start
us, end us)``, so that the CPU tests can feed it events of their own.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Callable, Dict, List, Sequence, Tuple

Event = Tuple[str, float, float]       # name, start us, end us
LABEL = "portbench."
STRETCH = LABEL + "stretch"


def span(name: str, on: bool):
    """The harness's span ``portbench.<name>`` in the profiler's trace
    when ``on``, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(LABEL + name)


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """The union of ``intervals`` as sorted, disjoint ``[start, end]``."""
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def idle_gaps(busy: List[List[float]], lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that ``busy`` leaves uncovered."""
    out, at = [], lo
    for b0, b1 in busy:
        if b0 > at:
            out.append((at, min(b0, hi)))
        at = max(at, b1)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def label_gaps(gaps, host: Sequence[Event]) -> Dict[str, float]:
    """Idle seconds by the innermost host event running at each gap's
    middle (host events of one thread nest); "no host event" where none
    runs."""
    hs = sorted(host, key=lambda e: (e[1], -e[2]))
    starts = [e[1] for e in hs]
    out: Dict[str, float] = {}
    stack: List[Event] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            e = hs[i]
            while stack and stack[-1][2] < e[1]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "no host event"
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return out


def reduce_events(device: Sequence[Event], host: Sequence[Event],
                  lo: float, hi: float) -> dict:
    """``device``: kernel and copy records; ``host``: the harness thread's
    host events; ``[lo, hi]``: the stretch, all in microseconds."""
    dev = [e for e in device if e[2] > lo and e[1] < hi]
    busy = union([(max(e[1], lo), min(e[2], hi)) for e in dev])
    kernels: Dict[str, List[float]] = {}
    for name, s, e in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": {k: (int(n), s) for k, (n, s) in kernels.items()},
        "idle_by_host": label_gaps(idle_gaps(busy, lo, hi), host),
    }


def _device_time_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_solves(solve: Callable[[], object], n: int, device) -> tuple:
    """Run ``solve`` ``n`` times under ``torch.profiler``; returns the
    reduced trace (:func:`reduce_events`, plus ``ops``: host operations by
    name with their count and the device seconds they launched) and the
    solves' results.  The card is synchronized and left idle 20 ms on each
    side of the stretch: the profiler keeps only the device records that
    lie inside its window as the host's clock places it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=acts) as prof:
        sync()
        time.sleep(0.02)
        with record_function(STRETCH):
            out = [solve() for _ in range(n)]
            sync()
        time.sleep(0.02)
    events = prof.events()
    stretch = [e for e in events
               if e.name == STRETCH and e.device_type == DeviceType.CPU]
    if not stretch:
        raise RuntimeError("the profiler recorded no stretch")
    st = stretch[0]
    lo, hi = st.time_range.start, st.time_range.end
    dev, host = [], []
    for e in events:
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CPU:
            if e.thread == st.thread:
                host.append(rec)
        elif not getattr(e, "is_user_annotation", False) and not (
                e.name.startswith(LABEL)):
            # a range the harness labels shows on the device's timeline
            # too; it is no device work
            dev.append(rec)
    red = reduce_events(dev, host, lo, hi)
    red["ops"] = {a.key: (int(a.count), _device_time_us(a) * 1e-6)
                  for a in prof.key_averages()
                  if getattr(a, "device_type", None) == DeviceType.CPU}
    return red, out
