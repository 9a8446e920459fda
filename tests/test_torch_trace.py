"""The port's spans and host-read counter (``utils/timing.py``) on the CPU:
the span tree and solve ids of a two-level FSAI-CG ``run()`` and of a
direct-locals ``run_accelerated()``, ``host_reads`` by site against counts
derived from each result, nothing recorded and nothing of the profiler
entered while recording is off, results bit for bit with it on and off,
and the ``schwarz.*`` events of ``torch.profiler`` nested as the spans
are.  A 16^2 Laplacian on 4 subdomains: seconds in all."""

from collections import Counter

import numpy as np
import pytest
import torch

import schwarz_tpu_torch.config as cfg
import schwarz_tpu_torch.models as models
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.ras import RASolver
from schwarz_tpu_torch.utils import timing

FLAGSHIP = dict(overlap=2, local_solver=cfg.LocalSolver.iterative_cg,
                precond=cfg.Precond.fsai, tolerance=1e-8, max_iters=200,
                dtype="float64", local_compute_dtype="float32",
                local_tolerance=1e-6, local_max_iters=20,
                row_pad_multiple=8, two_level=True, coarse_aggregates=4,
                coarse_space="spectral")
DIRECT = dict(partition=cfg.Partition.regular2d, overlap=2, dtype="float64",
              row_pad_multiple=8, local_solver=cfg.LocalSolver.direct_cholesky,
              direct_apply="inverse", accelerator="fgmres", restart_iter=5,
              tolerance=1e-8, max_iters=100, spmv_format="dia")
STEP_STAGES = {"exchange", "interface_update", "convergence_check",
               "coarse_correction", "residual_recompute", "local_solve",
               "expand"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    prev = timing.recording(False)
    timing.clear_spans()
    yield
    timing.recording(prev)
    timing.clear_spans()


def _build(settings, n=16, S=4, record=False):
    A = models.laplacian_2d(n)
    prev = timing.recording(record)
    try:
        dec = decompose(A, models.generate_rhs(A.n), cfg.Settings(**settings),
                        S)
        solver = RASolver(dec, device="cpu")
    finally:
        timing.recording(prev)
    return A, solver


def _rhs(n_rows, k):
    return np.random.default_rng(k).uniform(0.0, 1.0, n_rows)


def _solve(solver, rhs, entry, record):
    prev = timing.recording(record)
    try:
        solver.set_rhs(rhs)
        return getattr(solver, entry)()
    finally:
        timing.recording(prev)


def _reads(fn):
    before = timing.counts().get(timing.HOST_READS, {})
    out = fn()
    after = timing.counts()[timing.HOST_READS]
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v - before.get(k, 0)}


def _tree(spans):
    """(name, parent's name or None, solve) of every span."""
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None,
             s.solve) for s in spans]


def test_flagship_span_tree_and_solve_ids():
    A, solver = _build(FLAGSHIP, record=True)
    setup = _tree(timing.spans())
    assert ("decompose", None, 0) in setup
    assert ("solver_setup", None, 0) in setup
    for child in ("eigensolve", "fsai", "to_device"):
        assert (child, "solver_setup", 0) in setup
    timing.clear_spans()
    results = [_solve(solver, _rhs(A.n, k), "run", True) for k in (1, 2)]
    spans = timing.spans()
    tree = _tree(spans)
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    assert [(n, i) for n, p, i in tree if p is None] == [
        ("set_rhs", 1), ("run", 1), ("set_rhs", 2), ("run", 2)]
    for k, res in zip((1, 2), results):
        of = Counter((n, p) for n, p, i in tree if i == k)
        # every pass is a step; the detecting pass solves nothing
        assert of[("step", "run")] == res.iters + 1
        assert of[("prepare", "run")] == of[("assemble_result", "run")] == 1
        assert of[("local_solve", "step")] == res.iters
        assert of[("exchange", "step")] == 2 * res.iters + 1
        assert {n for n, p in of if p == "step"} == STEP_STAGES
    # a child starts and ends inside its parent
    for s in spans:
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def test_direct_fgmres_span_tree_and_solve_ids():
    A, solver = _build(DIRECT, record=True)
    setup = _tree(timing.spans())
    for child in ("factor", "inverse", "to_device"):
        assert (child, "solver_setup", 0) in setup
    timing.clear_spans()
    res = _solve(solver, _rhs(A.n, 3), "run_accelerated", True)
    tree = _tree(timing.spans())
    assert [(n, i) for n, p, i in tree if p is None] == [
        ("set_rhs", 1), ("run_accelerated", 1)]
    of = Counter((n, p) for n, p, i in tree)
    assert of[("fgmres.orthogonalize", "fgmres.cycle")] == res.iters
    assert of[("precond", "fgmres.cycle")] == res.iters
    assert of[("local_solve", "precond")] == res.iters
    assert of[("exchange", "precond")] == res.iters
    # the first residual's product runs before any cycle
    assert of[("matvec", "run_accelerated")] == 1
    assert {n for n, p in of if p == "run_accelerated"} == {
        "prepare", "matvec", "fgmres.cycle", "assemble_result"}


def test_request_ids_are_the_solvers():
    # each set_rhs joins the request its solver has open, the entry closes
    # it, and an entry with none open takes an id of its own
    A, solver = _build(DIRECT)
    timing.recording(True)
    solver.set_rhs(_rhs(A.n, 11))
    solver.set_rhs(_rhs(A.n, 12))
    solver.run_accelerated()
    solver.run_accelerated()
    solver.set_rhs(_rhs(A.n, 13))
    solver.run_accelerated()
    assert [(n, i) for n, p, i in _tree(timing.spans()) if p is None] == [
        ("set_rhs", 1), ("set_rhs", 1), ("run_accelerated", 1),
        ("run_accelerated", 2), ("set_rhs", 3), ("run_accelerated", 3)]


def test_host_reads_by_site_against_the_results():
    A, solver = _build(FLAGSHIP)
    res, reads = _reads(lambda: _solve(solver, _rhs(A.n, 4), "run", False))
    # CG reads its flag once a trip and once more when every subdomain
    # stopped before the cap (the cap ends the loop without a read)
    trips = res.inner_iters_history[:res.iters].max(axis=1)
    cap = FLAGSHIP["local_max_iters"]
    assert reads == {"cg.active": int(sum(t + (t < cap) for t in trips)),
                     "step.flags": res.iters + 1, "result": 1}

    A, solver = _build(DIRECT)
    res, reads = _reads(lambda: _solve(solver, _rhs(A.n, 5),
                                       "run_accelerated", False))
    assert reads["fgmres.column"] == res.iters
    assert reads["result"] == 1
    # ||b|| and the first residual, then two norms a restart cycle
    cycles = -(-res.iters // DIRECT["restart_iter"])
    assert reads["fgmres.norm"] == 2 + 2 * cycles
    assert set(reads) == {"fgmres.column", "fgmres.norm", "result"}


def test_gmres_and_coarse_cg_sites():
    kw = dict(FLAGSHIP, local_solver=cfg.LocalSolver.iterative_gmres,
              precond=cfg.Precond.none, restart_iter=5, local_max_iters=10,
              local_compute_dtype=None, coarse_solver="cg",
              tolerance=1e-6)
    A, solver = _build(kw)
    res, reads = _reads(lambda: _solve(solver, _rhs(A.n, 6), "run", False))
    assert res.converged
    assert reads["gmres.column"] >= res.iters
    assert reads["gmres.norm"] >= 3 * res.iters
    # the coarse CG reads its test once an iteration and once at its end
    assert reads["coarse_cg.active"] >= 2 * res.iters
    assert reads["step.flags"] == res.iters + 1


def test_off_records_nothing_and_enters_no_profiler(monkeypatch):
    A, solver = _build(FLAGSHIP)

    def refuse(*a, **k):
        raise AssertionError("a span entered the profiler while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(timing, "_record_function", refuse)
    monkeypatch.setattr(timing, "time", None)     # no clock either
    res = _solve(solver, _rhs(A.n, 7), "run", False)
    assert res.converged
    assert timing.spans() == []
    assert timing.span("step") is timing.span("run")


def test_on_without_a_profiler_enters_no_record_function(monkeypatch):
    A, solver = _build(DIRECT)
    timing.recording(True)
    with timing.span("first"):      # loads what an on span uses
        pass

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(timing, "_record_function", refuse)
    res = _solve(solver, _rhs(A.n, 10), "run_accelerated", True)
    assert res.converged
    assert len(timing.spans()) > res.iters


@pytest.mark.parametrize("settings, entry", [(FLAGSHIP, "run"),
                                             (DIRECT, "run_accelerated")],
                         ids=["flagship", "direct"])
def test_results_bit_for_bit_with_recording_on_and_off(settings, entry):
    A, solver = _build(settings)
    rhs = _rhs(A.n, 8)
    off = _solve(solver, rhs, entry, False)
    on = _solve(solver, rhs, entry, True)
    assert timing.spans()
    assert off.iters == on.iters
    np.testing.assert_array_equal(off.solution, on.solution)
    np.testing.assert_array_equal(off.global_resnorm_history,
                                  on.global_resnorm_history)
    np.testing.assert_array_equal(off.inner_iters_history,
                                  on.inner_iters_history)


def test_profiler_events_nest_as_the_spans():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    A, solver = _build(FLAGSHIP)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(solver, _rhs(A.n, 9), "run", True)
    events = sorted(
        ((e.name[len(timing.PREFIX):], e.time_range.start, e.time_range.end)
         for e in prof.events() if e.device_type == DeviceType.CPU
         and e.name.startswith(timing.PREFIX)),
        key=lambda e: (e[1], -e[2]))
    nested, stack = [], []
    for name, t0, t1 in events:
        while stack and stack[-1][2] < t1:
            stack.pop()
        nested.append((name, stack[-1][0] if stack else None))
        stack.append((name, t0, t1))
    spans = timing.spans()
    assert Counter(nested) == Counter((n, p) for n, p, _ in _tree(spans))
    assert len(events) == len(spans)


def test_cli_profile_dir_trace_carries_the_spans(tmp_path, capsys):
    import json

    from schwarz_tpu_torch import cli

    rc = cli.main(["--executor", "cpu", "--set_1d_laplacian_size", "16",
                   "--num_subdomains", "4", "--overlap", "2",
                   "--set_tol", "1e-6", "--profile_dir", str(tmp_path)])
    assert rc == 0
    capsys.readouterr()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"schwarz.run", "schwarz.step", "schwarz.local_solve"} <= names
    # the window restores the recorder's setting
    assert timing.recording(False) is False
