"""Fixtures of the benchmark's CPU tests: a checkout of its own in a
temporary directory, with the repository's metric readers and operator
builders and a tiny cell of each configuration, so that a whole run takes
seconds on the CPU."""

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
# the tiny size of each configuration, by its name in BENCHMARK.json
TINY = {"flagship_lap2d_512": dict(name="tiny_flagship", n=24, S=4,
                                   settings=dict(coarse_aggregates=4,
                                                 overlap=2)),
        "direct_fgmres_lap2d_512": dict(name="tiny_direct", n=24, S=4,
                                        settings=dict(overlap=2)),
        # 8 strips, 2 a process over the configuration's 4 processes
        "flagship_lap2d_512_4proc": dict(name="tiny_flagship_4proc", n=24,
                                         S=8,
                                         settings=dict(coarse_aggregates=4,
                                                       overlap=2))}
# the configuration across a process group, which no cell of
# BENCHMARK.json runs yet: the tiny cell of it, the per-layer metrics of
# BENCHMARK.json its cell reports, and its own, the mesh layer's
GROUP_CELL = {"name": "flagship_lap2d_512_4proc.rhs_stream",
              "config": "flagship_lap2d_512_4proc", "traffic": "rhs_stream",
              "chips": 4}
GROUP_PER_LAYER = ("solve_s.host_bound", "outer_iters",
                   "k1_launches_per_iter", "k1_roofline", "k2_roofline",
                   "device_idle")
MESH_METRICS = [
    {"name": "collective_ms_per_iter", "unit": "ms", "better": "lower",
     "source": "program_counter", "layer": "mesh", "moves": "solve_s.p90"},
    {"name": "collective_calls_per_iter", "unit": "calls",
     "better": "lower", "source": "program_counter", "layer": "mesh",
     "moves": "solve_s.p90"}]


def load(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(dest: str, bench: dict = None) -> str:
    """A checkout under ``dest``: the metrics of ``bench`` (the
    repository's ``BENCHMARK.json`` by default), the readers and builders,
    and the tiny cell of each of its cells (``tiny_flagship.rhs_stream``,
    ``tiny_direct.rhs_stream``) and of the group configuration
    (``tiny_flagship_4proc.rhs_stream``), the metrics' ``workloads``
    mapped onto them.  Where ``bench`` has no cell of the group
    configuration, or not the mesh layer's metrics, they are added by
    name, so that each is there once either way."""
    bench = copy.deepcopy(load("BENCHMARK.json") if bench is None else bench)
    pb = os.path.join(dest, "portbench")
    for sub in ("metrics", "operators"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(pb, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(HERE, "traffic"), os.path.join(pb, "traffic"))
    cells, tiny_of = [], {}
    group = ([GROUP_CELL] if all(c["name"] != GROUP_CELL["name"]
                                 for c in bench["workloads"]) else [])
    for cell in bench["workloads"] + group:
        cfg = load(f"portbench/configs/{cell['config']}.json")
        tiny = copy.deepcopy(cfg)
        t = TINY[cell["config"]]
        tiny["name"] = t["name"]
        tiny["operator"]["n"] = t["n"]
        tiny["num_subdomains"] = t["S"]
        tiny["settings"].update(t["settings"])
        write(os.path.join(pb, "configs", f"{t['name']}.json"), tiny)
        cells.append({"name": f"{t['name']}.{cell['traffic']}",
                      "config": t["name"], "traffic": cell["traffic"],
                      "chips": cell["chips"], "why": "a CPU test"})
        tiny_of[cell["name"]] = cells[-1]["name"]
    bench["workloads"] = cells
    bench["configs"] = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"]]
            if group and m["name"] in GROUP_PER_LAYER:
                m["workloads"].append(tiny_of[GROUP_CELL["name"]])
    have = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [dict(m, workloads=[tiny_of[GROUP_CELL["name"]]])
                           for m in MESH_METRICS if m["name"] not in have]
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
