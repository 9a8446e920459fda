"""Discovery by name: everything that belongs to one configuration, one
traffic mix or one metric is a file of its own, found from the names in
``BENCHMARK.json``, so that a new cell adds files and edits none.

    portbench/configs/<config>.json      the configuration (data)
    portbench/operators/<kind>.py        builds the operator a configuration
                                         names, ``build(spec)`` (NumPy/SciPy)
    portbench/traffic/<traffic>.json     the traffic mix (data)
    portbench/metrics/<metric>.py        the metric's reader, ``read(ctx)``

``root`` is the directory that holds ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os

PACKAGE = "portbench"


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[c['name'] for c in bench['workloads']]}")


def _json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, PACKAGE, kind, f"{name}.json")) as f:
        return json.load(f)


def config(root: str, name: str) -> dict:
    return _json(root, "configs", name)


def traffic(root: str, name: str) -> dict:
    return _json(root, "traffic", name)


def _module(root: str, kind: str, name: str):
    path = os.path.join(root, PACKAGE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{kind}.{name}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operator(root: str, kind: str):
    """The module that builds operators of ``kind``."""
    return _module(root, "operators", kind)


def reader(root: str, metric: str):
    """The reader of ``metric``: its module's ``read``."""
    return _module(root, "metrics", metric).read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it; a metric with a ``workloads``
    list only in the cells it names."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]
