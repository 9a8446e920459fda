"""Fixtures of the benchmark's CPU tests: a checkout of its own in a
temporary directory, with the repository's metric readers and operator
builders and tiny cells of both configurations, so that a whole run takes
seconds on the CPU."""

from __future__ import annotations

import copy
import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TINY = {"flagship": dict(n=24, S=4, settings=dict(coarse_aggregates=4,
                                                 overlap=2)),
        "direct": dict(n=24, S=4, settings=dict(overlap=2))}
CELLS = {"flagship": "flagship_lap2d_512", "direct": "direct_fgmres_lap2d_512"}


def load(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(dest: str) -> str:
    """A checkout under ``dest``: the repository's ``BENCHMARK.json``
    metrics, readers and builders, and one tiny cell per configuration
    (``tiny_flagship.rhs_stream``, ``tiny_direct.rhs_stream``)."""
    bench = load("BENCHMARK.json")
    pb = os.path.join(dest, "portbench")
    for sub in ("metrics", "operators"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(pb, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(HERE, "traffic"), os.path.join(pb, "traffic"))
    cells, tiny_of = [], {}
    for short, name in CELLS.items():
        cfg = load(f"portbench/configs/{name}.json")
        tiny = copy.deepcopy(cfg)
        t = TINY[short]
        tiny["name"] = f"tiny_{short}"
        tiny["operator"]["n"] = t["n"]
        tiny["num_subdomains"] = t["S"]
        tiny["settings"].update(t["settings"])
        write(os.path.join(pb, "configs", f"tiny_{short}.json"), tiny)
        cells.append({"name": f"tiny_{short}.rhs_stream",
                      "config": f"tiny_{short}", "traffic": "rhs_stream",
                      "chips": 1, "why": "a CPU test"})
        tiny_of[f"{name}.rhs_stream"] = cells[-1]["name"]
    bench["workloads"] = cells
    bench["configs"] = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"]]
    write(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
