"""The benchmark's byte and operation counts against hand counts at small
shapes, and the reduction of a device trace on events of the test's own."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import devtrace, registry
from portbench.conftest import ROOT
from portbench.metrics import inverse_apply_roofline as inv_mod
from portbench.metrics import k1_roofline as k1_mod
from portbench.metrics import k2_roofline as k2_mod
from portbench.metrics.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S, bound_s
from portbench.readings import Readings, Solve


def test_peaks_are_the_published_ones():
    assert HBM_BYTES_PER_S == 3.35e12
    assert PEAK_OPS_PER_S == {"float32": 67e12, "float64": 34e12}
    # bytes bound: 3.35e12 bytes take a second, 67e12 float32 operations too
    assert bound_s(3.35e12, 1.0, "float32") == pytest.approx(1.0)
    assert bound_s(1.0, 34e12, "float64") == pytest.approx(1.0)
    assert bound_s(6.7e12, 67e12, "float32") == pytest.approx(2.0)


@pytest.mark.parametrize("key, want_bytes, want_ops", [
    # S=2, K=3, R=10, float32: 60 diagonal entries, x and y 20 each
    (((-1, 0, 1), "float32"), (60 + 20 + 20) * 4, 2 * 60),
    # the same in float64
    (((-1, 0, 1), "float64"), (60 + 20 + 20) * 8, 2 * 60),
    # a chain with 2 + 1 diagonals: both operators, x and z
    (("chain", (-1, 0), (0,), "float32"), (40 + 20 + 20 + 20) * 4,
     2 * 60),
])
def test_k1_launch_against_hand_count(key, want_bytes, want_ops):
    nbytes, ops, dtype = k1_mod.launch(key, 2, 10)
    assert (nbytes, ops, dtype) == (want_bytes, want_ops, key[-1])


def test_k2_launch_bytes_against_hand_count():
    # S=2 rows of r_ext=6: row 0 zero(1) window(3, src 0..2) halo(2, src
    # 3..4); row 1 window(4, src 3..6) halo(2, src 0..1).  all_gather
    # form: one source, read elements {0..6} = 7
    segs = np.array([[0, 1, 0, 0], [1, 3, 1, 0], [4, 2, 2, 3],
                     [6, 4, 1, 3], [10, 2, 2, 0]], np.int32)
    first = np.zeros((2, 2), np.int32)
    table = (segs.size + first.size) * 4
    got = k2_mod.launch_bytes(segs, first, 2, 6, True, 8)
    assert got == (2 * 6 + 7) * 8 + table
    # two sources: window reads {0..6} (7), halo reads {0,1,3,4} (4)
    got2 = k2_mod.launch_bytes(segs, first, 2, 6, False, 4)
    assert got2 == (2 * 6 + 7 + 4) * 4 + table


def test_inverse_apply_bytes_against_hand_count():
    # (2, 3, 3) inverse and (2, 3) vectors in and out, float64
    assert inv_mod.apply_bytes(2, 3, 8) == (18 + 6 + 6) * 8


def _ctx(**kw) -> Readings:
    base = dict(cell="c", config={}, traffic={}, platform="gpu", setup_s=1.0,
                setup_split={}, window_s=2.0,
                solves=[Solve(1, 0.5, 0.0, 0.5, 0.4, 10, True),
                        Solve(2, 1.5, 0.0, 1.5, 1.4, 12, True)],
                counters={"dia_spmv": {"launches": 44, "launches_by": {}}},
                shapes=dict(S=2, R_rows=10, R_ext=6, dtype="float64",
                            halo_strategy="all_gather", inverse=(2, 3, 3),
                            inverse_dtype="float64"),
                tables={})
    base.update(kw)
    return Readings(**base)


def _read(name, ctx):
    return registry.reader(ROOT, name)(ctx)


def test_readers_on_readings_of_the_test():
    key = ((-1, 0, 1), "float32")
    b1 = bound_s(*k1_mod.launch(key, 2, 10))
    prof = {"window_s": 4.0, "busy_s": 1.0,
            "kernels": {"void dia_spmv_kernel<3, float>(...)": (4, 8 * b1),
                        "void assemble_kernel<double, double>(...)":
                            (3, 1e-6),
                        "gemv2T_kernel": (2, 1e-3)},
            "ops": {"aten::bmm": (2, 1e-3)},
            "counters": {"dia_spmv": {"launches": 4,
                                      "launches_by": {key: 4}},
                         "assemble_x_ext": {"launches": 3}},
            "idle_by_host": {}}
    ctx = _ctx(profile=prof)
    assert _read("k1_roofline", ctx) == pytest.approx(50.0)
    assert _read("device_idle", ctx) == pytest.approx(75.0)
    assert _read("outer_iters", ctx) == 11.0
    assert _read("k1_launches_per_iter", ctx) == pytest.approx(2.0)
    assert _read("solve_s", ctx) == pytest.approx(1.0)
    assert _read("solve_s.p90", ctx) == pytest.approx(1.4)
    assert _read("solve_s.host_bound", ctx) == _read("solve_s", ctx)
    inv_bound = bound_s(inv_mod.apply_bytes(2, 3, 8), 2 * 18, "float64")
    assert _read("inverse_apply_roofline", ctx) == pytest.approx(
        100 * 2 * inv_bound / 1e-3)
    # no tables, no trace, no counts: nothing to read
    assert _read("k2_roofline", ctx) is None
    assert _read("k1_roofline", _ctx()) is None
    assert _read("local_solve_share", ctx) is None
    inst = [{"stage_timings": {"local_solve": {"total": 0.3}},
             "loop_s": 0.4, "iters": 18}] * 2
    assert _read("local_solve_share", _ctx(instrumented=inst)) == \
        pytest.approx(75.0)


def test_trace_reduction_on_events_of_the_test():
    dev = [("k", 10.0, 20.0), ("k", 15.0, 30.0), ("copy", 50.0, 60.0),
           ("k", 95.0, 130.0)]
    host = [("portbench.entry", 0.0, 100.0), ("aten::item", 35.0, 45.0),
            ("cudaLaunchKernel", 62.0, 90.0)]
    red = devtrace.reduce_events(dev, host, 0.0, 100.0)
    assert red["window_s"] == pytest.approx(1e-4)
    # busy: [10, 30] + [50, 60] + [95, 100]
    assert red["busy_s"] == pytest.approx(35e-6)
    assert red["kernels"]["k"][0] == 3
    assert red["kernels"]["k"][1] == pytest.approx((10 + 15 + 35) * 1e-6)
    # idle [0, 10] and [30, 50] under the entry and aten::item, [60, 95]
    # under the launch
    idle = red["idle_by_host"]
    assert idle["portbench.entry"] == pytest.approx(10e-6)
    assert idle["aten::item"] == pytest.approx(20e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(35e-6)
    assert sum(idle.values()) + red["busy_s"] == pytest.approx(1e-4)
