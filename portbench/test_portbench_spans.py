"""The readings of :mod:`portbench.spans` on spans, counts and events of
the test's own."""

from __future__ import annotations

import pytest

from portbench import devtrace, spans
from schwarz_tpu_torch.utils import timing
from schwarz_tpu_torch.utils.timing import Span


def _ms(name, t0, t1, parent=-1, solve=0):
    return Span(name, int(t0 * 1e6), int(t1 * 1e6), parent, solve)


# set-up, then two requests: set_rhs, the entry with prepare, two local
# solves and assemble_result (milliseconds)
SPANS = [_ms("decompose", 0, 5), _ms("solver_setup", 5, 100),
         _ms("eigensolve", 10, 70, 1), _ms("eigensolve", 70, 80, 1),
         _ms("set_rhs", 100, 104, -1, 1), _ms("run", 104, 200, -1, 1),
         _ms("prepare", 104, 105, 5, 1), _ms("local_solve", 110, 130, 5, 1),
         _ms("local_solve", 140, 160, 5, 1),
         _ms("assemble_result", 190, 200, 5, 1),
         _ms("set_rhs", 200, 202, -1, 2), _ms("run", 202, 300, -1, 2),
         _ms("prepare", 202, 203, 11, 2),
         _ms("local_solve", 210, 250, 11, 2),
         _ms("assemble_result", 290, 296, 11, 2)]


def test_prefix_is_the_programs():
    assert spans.PREFIX == timing.PREFIX


def test_readings_on_spans_of_the_test():
    # (4 + 1 + 10) and (2 + 1 + 6) ms
    assert spans.fixed_cost_s(SPANS) == pytest.approx(12e-3)
    assert spans.per_solve(SPANS, ("local_solve",)) == pytest.approx(
        {1: 40e-3, 2: 40e-3})
    # the set-up's eigensolves only
    assert spans.eigensolve_s(SPANS) == pytest.approx(70e-3)
    assert spans.eigensolve_s(SPANS[4:]) is None
    ops = {"schwarz.local_solve": (3, 8e-3), "aten::mul": (9, 1e-3)}
    assert spans.local_solve_device_busy(SPANS, ops) == pytest.approx(10.0)
    assert spans.local_solve_device_busy(SPANS, {}) is None
    assert spans.fixed_cost_s(SPANS[:4]) is None
    assert spans.host_reads_per_iter(42, 20) == pytest.approx(2.1)
    assert spans.host_reads_per_iter(0, 20) is None


def test_idle_by_span_on_events_of_the_test():
    host = [("portbench.entry", 0.0, 100.0), ("schwarz.run", 5.0, 95.0),
            ("schwarz.step", 10.0, 50.0), ("aten::item", 30.0, 45.0),
            ("schwarz.local_solve", 60.0, 90.0),
            ("cudaLaunchKernel", 62.0, 70.0)]
    busy = [[20.0, 25.0], [50.0, 55.0], [80.0, 96.0]]
    gaps = devtrace.idle_gaps(busy, 0.0, 100.0)
    idle = spans.idle_by_span(gaps, host)
    # [0, 20] under schwarz.step at its middle 10, [25, 50] under step
    # (aten::item is no span), [55, 80] under local_solve, [96, 100]
    # outside the program's spans
    assert idle == pytest.approx({"schwarz.step": 45e-6,
                                  "schwarz.local_solve": 25e-6,
                                  spans.OUTSIDE: 4e-6})
    assert sum(idle.values()) == pytest.approx(
        sum(b - a for a, b in gaps) * 1e-6)


def test_copies_by_the_operation_that_made_them():
    chains = [["aten::copy_", "aten::_to_copy", "aten::to",
               "schwarz.fgmres.orthogonalize", "schwarz.fgmres.cycle"],
              ["aten::copy_", "aten::_local_scalar_dense", "aten::item",
               "aten::is_nonzero", "schwarz.local_solve", "schwarz.step"],
              ["aten::copy_", "aten::_to_copy", "aten::to",
               "portbench.stretch"]]
    got = spans.copies_by_op(chains * 2)
    assert got == {("schwarz.fgmres.orthogonalize", "aten::to"): 2,
                   ("schwarz.local_solve", "aten::is_nonzero"): 2,
                   (spans.OUTSIDE, "aten::to"): 2}
