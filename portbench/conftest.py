"""Fixtures of the benchmark's CPU tests: a checkout of its own in a
temporary directory, with the repository's metric readers and operator
builders and a tiny cell of each configuration, so that a whole run takes
seconds on the CPU.  A configuration's tiny size is a file of its own,
``tiny/<config>.json``, found by the configuration's name: this file
holds no configuration's data."""

from __future__ import annotations

import copy
import json
import os
import pickle
import shutil
import tempfile

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_file(config: str) -> dict:
    """The tiny size of configuration ``config``: ``tiny/<config>.json``,
    with ``name``, ``operator`` and ``settings`` (merged into the
    configuration's), ``num_subdomains``, and optionally
    ``cpu_trace_metrics`` (what a traced run of its tiny cell reads on the
    CPU) and ``pending`` (the cell of a configuration that no cell of
    ``BENCHMARK.json`` runs yet: its ``traffic``, ``chips``, the
    per-layer metrics of ``BENCHMARK.json`` it ``reports``, and its own
    ``per_layer`` entries)."""
    path = os.path.join(HERE, "tiny", f"{config}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"configuration {config!r} has no tiny cell for the CPU tests: "
            f"add portbench/tiny/{config}.json (name, operator, "
            f"num_subdomains, settings)")
    with open(path) as f:
        return json.load(f)


def pending(bench: dict) -> list:
    """``(config, its tiny file's pending)`` of each tiny file whose
    pending cell ``bench`` does not run, in the order of the files."""
    names = {c["name"] for c in bench["workloads"]}
    out = []
    for f in sorted(os.listdir(os.path.join(HERE, "tiny"))):
        config = f[:-len(".json")]
        p = tiny_file(config).get("pending")
        if p and f"{config}.{p['traffic']}" not in names:
            out.append((config, p))
    return out


def _tiny(bench: dict = None):
    """The test checkout's ``BENCHMARK.json``, from ``bench`` (the
    repository's by default): a tiny cell of each of its cells and of
    each pending cell, the metrics' ``workloads`` mapped onto them, a
    pending cell added to the metrics it reports and its own metrics
    added; with the tiny configurations and tiny files by tiny name."""
    bench = copy.deepcopy(load("BENCHMARK.json") if bench is None else bench)
    todo = pending(bench)
    cells = bench["workloads"] + [
        {"name": f"{config}.{p['traffic']}", "config": config,
         "traffic": p["traffic"], "chips": p["chips"]} for config, p in todo]
    configs, files, tiny_of, workloads = {}, {}, {}, []
    for cell in cells:
        t = tiny_file(cell["config"])
        cfg = load(f"portbench/configs/{cell['config']}.json")
        cfg["name"] = t["name"]
        cfg["operator"].update(t["operator"])
        cfg["num_subdomains"] = t["num_subdomains"]
        cfg["settings"].update(t["settings"])
        configs[t["name"]], files[t["name"]] = cfg, t
        tiny_of[cell["name"]] = f"{t['name']}.{cell['traffic']}"
        workloads.append({"name": tiny_of[cell["name"]],
                          "config": t["name"], "traffic": cell["traffic"],
                          "chips": cell["chips"], "why": "a CPU test"})
    bench["workloads"] = workloads
    bench["configs"] = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"]]
    have = {m["name"] for m in bench["per_layer"]}
    for config, p in todo:
        cell = tiny_of[f"{config}.{p['traffic']}"]
        for m in bench["per_layer"]:
            if m["name"] in p["reports"] and "workloads" in m:
                m["workloads"].append(cell)
        bench["per_layer"] += [dict(m, workloads=[cell])
                               for m in p["per_layer"]
                               if m["name"] not in have]
    return bench, configs, files


def tiny_cells() -> list:
    """``(name, configuration, tiny file)`` of each cell of the test
    checkout, in its ``BENCHMARK.json``'s order: the cells the control,
    fault and card tests run."""
    bench, configs, files = _tiny()
    return [(c["name"], configs[c["config"]], files[c["config"]])
            for c in bench["workloads"]]


def make_root(dest: str, bench: dict = None) -> str:
    """A checkout under ``dest``: the readers, the builders, the traffic
    mixes, and the tiny cells of ``bench`` (the repository's
    ``BENCHMARK.json`` by default) and of the pending cells, as
    :func:`tiny_cells` lists them; each cell is there once."""
    bench, configs, _ = _tiny(bench)
    pb = os.path.join(dest, "portbench")
    for sub in ("metrics", "operators", "traffic"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(pb, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in configs.items():
        write(os.path.join(pb, "configs", f"{name}.json"), cfg)
    write(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))


@pytest.fixture
def run_tmpdir(tmp_path, monkeypatch):
    """``$TMPDIR`` of the runs: a group's work directories under it."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return str(d)


def group_workers(tmp: str, cell: str, seed: int) -> list:
    """What each worker of a group run wrote, in process order."""
    work = os.path.join(tmp, "portbench", "group", f"{cell}.{seed}")
    names = sorted((n for n in os.listdir(work) if n.endswith(".pkl")),
                   key=lambda n: int(n[1:-4]))
    out = []
    for name in names:
        with open(os.path.join(work, name), "rb") as f:
            out.append(pickle.load(f))
    return out
