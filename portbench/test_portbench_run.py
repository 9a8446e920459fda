"""A whole run of a tiny cell on the CPU: the last line's format, the
numbers compared on standard error, the exits without a card or with JAX
loaded, and the reference at a tiny size."""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from portbench import group, registry, run
from portbench.conftest import ROOT, group_workers, tiny_cells
from portbench.operators import laplacian_2d
from portbench.reference import direct, residual

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _emit(out):
    o, e = io.StringIO(), io.StringIO()
    with redirect_stdout(o), redirect_stderr(e):
        run.emit(out)
    return o.getvalue().splitlines(), e.getvalue().splitlines()


@pytest.mark.parametrize("cell", [name for name, cfg, _ in tiny_cells()
                                  if group.processes(cfg) == 1])
def test_last_line_format(tiny_root, cell):
    out = run.run_cell(cell, 2**31 + 7, 0.3, False, root=tiny_root,
                       device="cpu")
    lines, err = _emit(out)
    line = json.loads(lines[-1])
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {m["name"] for m in registry.cell_metrics(
        registry.load_benchmark(tiny_root), cell, False)}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"] == "s"
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    c = line["checks"]["rel_residual_max"]
    assert c["limit"] == 1e-8 and 0 < c["value"] <= 1e-8
    assert err[-2] == f"check rel_residual_max {c['value']} limit 1e-08"
    assert err[-1].startswith("correct true")


# a CPU run launches no kernel: only the counters, spans and, across
# processes, the mesh layer read; each tiny file that names what they
# read (``cpu_trace_metrics``) has its cell's traced line checked
TRACED = {name: set(tiny["cpu_trace_metrics"])
          for name, _, tiny in tiny_cells() if "cpu_trace_metrics" in tiny}


@pytest.mark.parametrize("cell", sorted(TRACED))
def test_traced_line_format(tiny_root, run_tmpdir, cell):
    out = run.run_cell(cell, 11, 0.3, True, root=tiny_root, device="cpu")
    line = json.loads(_emit(out)[0][-1])
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["metrics"]) == TRACED[cell]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    cfg = registry.config(tiny_root, registry.workload(
        registry.load_benchmark(tiny_root), cell)["config"])
    if "local_solve_share" in TRACED[cell]:
        assert 0 < line["metrics"]["local_solve_share"]["value"] < 100
    P = group.processes(cfg)
    if P == 1:
        # window, profiled and instrumented solves all judged
        assert line["attempted"] >= 1 + run.PROFILED_SOLVES + (
            run.INSTRUMENTED_SOLVES if cfg.get("instrumented_entry") else 0)
        return
    assert line["device"]["count"] == P
    assert line["metrics"]["collective_calls_per_iter"]["value"] > 1
    assert line["metrics"]["collective_ms_per_iter"]["value"] > 0
    counts = {w["counts"] for w in group_workers(run_tmpdir, cell, 11)}
    assert len(counts) == 1
    window, traced, instrumented = counts.pop()
    assert traced == run.PROFILED_SOLVES and instrumented == 0
    # window and profiled solves all judged
    assert line["attempted"] == window + traced


def test_same_seed_same_requests():
    mix = {"pool": 3, "warmup_solves": 1,
           "rhs": {"distribution": "uniform", "low": 0.0, "high": 1.0}}
    from portbench import generator

    a = generator.make_requests(mix, 50, 2**31 + 3, "cpu")
    b = generator.make_requests(mix, 50, 2**31 + 3, "cpu")
    c = generator.make_requests(mix, 50, 2**31 + 4, "cpu")
    assert a.shape == (3, 50) and a.dtype == np.float64
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (a >= 0).all() and (a < 1).all()
    assert [generator.row(mix, k) for k in range(5)] == [1, 2, 1, 2, 1]


def test_no_card_no_result(capsys):
    if run.torch_cuda_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "flagship_lap2d_512.rhs_stream",
                   "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == run.EXIT_NO_DEVICE and out.out == ""


def test_jax_loaded_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {
        "result": {"correct": True}, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "x", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == run.EXIT_FORBIDDEN and out.out == ""
    assert "jax" in out.err


def test_bare_directory_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the files under paths."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "flagship_lap2d_512.rhs_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_reference_at_a_tiny_size():
    A = laplacian_2d.build({"n": 3})
    dense = A.toarray()
    assert A.nnz == 5 * 9 - 4 * 3
    assert (np.diag(dense) == 4).all()
    assert dense[2, 3] == 0 and dense[3, 2] == 0      # no wrap across rows
    assert dense[0, 1] == -1 and dense[0, 3] == -1
    A = laplacian_2d.build({"n": 40})
    b = np.random.default_rng(0).uniform(size=A.shape[0])
    x = direct.solve(A, b)
    assert residual.relative_residual(A, b, x) < 1e-12
    assert np.allclose(A @ x, b, rtol=0, atol=1e-12)
    assert residual.relative_residual(A, b, np.zeros_like(b)) == 1.0
    assert residual.relative_residual(A, b, x[:-1]) == float("inf")
    bad = x.copy()
    bad[5] = np.nan
    assert residual.relative_residual(A, b, bad) == float("inf")
    # one precision below: the reference in float32 misses 1e-8
    x32 = direct.solve(A, b, np.float32)
    assert residual.relative_residual(A, b, x32) > 1e-8
