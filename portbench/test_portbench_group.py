"""A cell across a process group on the CPU: a tiny flagship cell over
2- and 4-process gloo groups (``portbench.group``), its result line, the
same solves in every process, the exits when a worker dies mid-window or
the cards are too few, and the pieces of the launcher.  The traced line
of the group cell is ``test_portbench_run.py``'s."""

from __future__ import annotations

import functools
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from portbench import group, run
from portbench.conftest import group_workers, write

GROUP = "tiny_flagship_4proc.rhs_stream"
SEED = 2**31 + 5
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _with_processes(root: str, P: int) -> str:
    """The tiny group cell's configuration over ``P`` processes, as a cell
    of its own; returns its name."""
    pb = os.path.join(root, "portbench")
    cfg = load_json(os.path.join(pb, "configs", "tiny_flagship_4proc.json"))
    cfg.update(name=f"tiny_flagship_{P}p", processes=P)
    write(os.path.join(pb, "configs", f"tiny_flagship_{P}p.json"), cfg)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    name = f"tiny_flagship_{P}p.rhs_stream"
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": "rhs_stream", "chips": P,
                               "why": "a CPU test"})
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return name


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("P", [2, 4])
def test_group_line(tiny_root, run_tmpdir, P):
    cell = GROUP if P == 4 else _with_processes(tiny_root, P)
    out = run.run_cell(cell, SEED, 1.0, False, root=tiny_root, device="cpu")
    assert out.pop("forbidden") == []
    line = out["result"]
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "solve_s.p90"}
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": P,
                              "memory_peak_bytes": 0}
    workers = group_workers(run_tmpdir, cell, SEED)
    assert len(workers) == P
    counts = {w["counts"] for w in workers}
    assert len(counts) == 1
    window, traced, instrumented = counts.pop()
    assert window >= 1 and traced == instrumented == 0
    # process 0 keeps every solution, and the check judged each
    assert line["attempted"] == window
    c = line["checks"]["rel_residual_max"]
    assert 0 < c["value"] <= c["limit"] == 1e-8


def kill_mid_window(solver):
    """Worker 1 dies at its first solve of the window (after the mix's
    two warm-up solves)."""
    entry, calls = solver.run, []

    def dying(*a, **k):
        calls.append(1)
        if solver.mesh.process_index == 1 and len(calls) > 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return entry(*a, **k)

    solver.run = dying


def _processes_naming(text: str) -> list:
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if text.encode() in f.read():
                    found.append(int(pid))
        except OSError:
            pass
    return found


def test_killed_worker_no_result(tiny_root, run_tmpdir, monkeypatch,
                                 capsys):
    monkeypatch.setattr(run, "run_cell", functools.partial(
        run.run_cell, root=tiny_root, device="cpu",
        program_hook=kill_mid_window))
    rc = run.main(["--workload", GROUP, "--seed", str(SEED), "--seconds",
                   "5", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == run.EXIT_GROUP_FAILED and out.out == ""
    assert "worker 1 (exit -9)" in out.err
    work = os.path.join(run_tmpdir, "portbench", "group")
    assert _processes_naming(work) == []


def test_fewer_cards_than_processes(tiny_root, run_tmpdir, monkeypatch,
                                    capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(run, "run_cell", functools.partial(
        run.run_cell, root=tiny_root))
    rc = run.main(["--workload", GROUP, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc == run.EXIT_NO_DEVICE and out.out == ""
    assert "needs 4 CUDA card(s)" in out.err
    work = os.path.join(run_tmpdir, "portbench", "group")
    assert _processes_naming(work) == []


def test_launch_kills_every_worker(tmp_path):
    """One worker fails at once: the others, asleep, are killed."""
    code = ("import sys, time; pid = int(sys.argv[1]);"
            " sys.exit(3) if pid == 2 else time.sleep(600)")
    with pytest.raises(group.GroupFailed) as e:
        group.launch([sys.executable, "-c", code], 4, str(tmp_path), 60)
    assert "exited [-9, -9, 3, -9]" in str(e.value)
    assert _processes_naming("time.sleep(600)") == []


def test_launch_timeout(tmp_path):
    with pytest.raises(group.GroupFailed) as e:
        group.launch([sys.executable, "-c", "import time; time.sleep(600)"],
                     2, str(tmp_path), 1.0)
    assert "exited [-9, -9]" in str(e.value)


def test_run_bound(tmp_path):
    """run_seconds + 60, and the build's seconds beyond it up to the first
    run's 1200 s."""
    work = str(tmp_path)
    limit = group.run_bound(51, work)
    assert limit() == 111
    group._mark(work, "building")
    assert limit() == 1200
    group._mark(work, "40.5")
    assert limit() == 151.5
    group._mark(work, "2000.0")
    assert limit() == 1200


def test_pool_digest():
    a = np.random.default_rng(0).uniform(size=(4, 10))
    b = a.copy()
    assert group.pool_digest(a) == group.pool_digest(b)
    b[2, 3] = np.nextafter(b[2, 3], 2)
    assert group.pool_digest(a) != group.pool_digest(b)
    assert group.pool_digest(a) != group.pool_digest(a[::-1])


def test_one_process_readings_have_no_mesh(tiny_root):
    m = run.measure("tiny_flagship.rhs_stream", 3, 0.2, False,
                    root=tiny_root, device="cpu", settings_override=None,
                    program_hook=None, t_start=run._T_START)
    assert m["mesh"] is None and run.readings(m).mesh is None
    assert m["counts"][0] == len(m["solves"]) == len(m["solved"])


def test_jax_in_a_worker_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {
        "result": {"correct": True}, "checks": {}, "forbidden": ["jax"]})
    rc = run.main(["--workload", GROUP, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == run.EXIT_FORBIDDEN and out.out == ""
    assert "jax" in out.err
