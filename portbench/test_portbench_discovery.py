"""Discovery by name: a new configuration, traffic mix and metric are
found from their files and the new ``BENCHMARK.json`` entries, with no
edit to any file that was there; and nothing the benchmark runs imports
JAX or the JAX package."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys

from portbench import registry, run
from portbench.conftest import (GROUP_CELL, GROUP_PER_LAYER, HERE,
                                MESH_METRICS, ROOT, load, make_root, write)


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_takes_no_edit(tiny_root):
    before = _digests(tiny_root)
    pb = os.path.join(tiny_root, "portbench")
    cfg = load("portbench/configs/flagship_lap2d_512.json")
    cfg.update(name="later_cfg", num_subdomains=2)
    cfg["operator"]["n"] = 16
    cfg["settings"].update(coarse_aggregates=2, overlap=1)
    write(os.path.join(pb, "configs", "later_cfg.json"), cfg)
    write(os.path.join(pb, "traffic", "later_mix.json"),
          {"pool": 4, "warmup_solves": 1,
           "rhs": {"distribution": "uniform", "low": 0.5, "high": 1.5}})
    with open(os.path.join(pb, "metrics", "set_rhs_share.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return 100 * sum(s.set_rhs_s for s in ctx.solves) / "
                "ctx.window_s\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.remove(os.path.join(tiny_root, "BENCHMARK.json"))
    bench["workloads"].append({"name": "later_cfg.later_mix",
                               "config": "later_cfg", "traffic": "later_mix",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "set_rhs_share", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "entry point", "moves": "solve_s.p90",
                               "workloads": ["later_cfg.later_mix"]})
    write(os.path.join(tiny_root, "BENCHMARK.json"), bench)
    out = run.run_cell("later_cfg.later_mix", 5, 0.3, True, root=tiny_root,
                       device="cpu")["result"]
    assert out["correct"] is True
    assert 0 < out["metrics"]["set_rhs_share"]["value"] < 100
    after = _digests(tiny_root)
    changed = [p for p, h in before.items()
               if after.get(p) != h and not p.endswith("BENCHMARK.json")]
    assert changed == []


def test_metrics_of_a_cell():
    bench = registry.load_benchmark(ROOT)
    assert [m["name"] for m in registry.cell_metrics(
        bench, "flagship_lap2d_512.rhs_stream", False)] \
        == ["setup_s", "solve_s.p90"]
    cell = "direct_fgmres_lap2d_512.rhs_stream"
    assert [m["name"] for m in registry.cell_metrics(bench, cell, False)] \
        == ["setup_s", "solve_s", "solve_s.p90"]
    names = [m["name"] for m in registry.cell_metrics(bench, cell, True)]
    assert "inverse_apply_roofline" in names
    assert "local_solve_share" not in names
    assert "solve_s.host_bound" not in names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(ROOT, m["name"]))


def test_tiny_root_maps_every_cell(tiny_root):
    """Every cell of BENCHMARK.json, and the group configuration's, has a
    tiny cell of the same chips and processes."""
    bench = registry.load_benchmark(ROOT)
    tiny = registry.load_benchmark(tiny_root)
    real = bench["workloads"]
    if all(c["name"] != GROUP_CELL["name"] for c in real):
        real = real + [GROUP_CELL]
    assert len(tiny["workloads"]) == len(real)
    for cell, small in zip(real, tiny["workloads"]):
        assert small["chips"] == cell["chips"]
        assert registry.config(tiny_root, small["config"]).get(
            "processes", 1) == registry.config(ROOT, cell["config"]).get(
            "processes", 1)
    assert [m["name"] for m in registry.cell_metrics(
        tiny, "tiny_flagship_4proc.rhs_stream", True)] == [
        "solve_s.host_bound", "outer_iters", "k1_launches_per_iter",
        "k1_roofline", "k2_roofline", "device_idle",
        "collective_ms_per_iter", "collective_calls_per_iter"]
    for m in MESH_METRICS:
        assert callable(registry.reader(ROOT, m["name"]))


def test_tiny_root_maps_the_group_cell_once(tmp_path):
    """With the group cell and the mesh metrics entered in
    ``BENCHMARK.json``, as a later PR enters them, each is mapped once."""
    bench = registry.load_benchmark(ROOT)
    cell = dict(GROUP_CELL, why="the flagship over 4 processes")
    bench["workloads"].append(cell)
    for m in bench["per_layer"]:
        if m["name"] in GROUP_PER_LAYER:
            m["workloads"].append(cell["name"])
    bench["per_layer"] += [dict(m, workloads=[cell["name"]])
                           for m in MESH_METRICS]
    root = make_root(str(tmp_path), bench)
    tiny = registry.load_benchmark(root)
    names = [c["name"] for c in tiny["workloads"]]
    assert sorted(names) == sorted(set(names))
    assert len(names) == len(bench["workloads"])
    metrics = [m["name"] for m in tiny["end_to_end"] + tiny["per_layer"]]
    assert sorted(metrics) == sorted(set(metrics))
    for m in tiny["end_to_end"] + tiny["per_layer"]:
        ws = m.get("workloads", [])
        assert sorted(ws) == sorted(set(ws)), m["name"]
    assert [m["name"] for m in registry.cell_metrics(
        tiny, "tiny_flagship_4proc.rhs_stream", True)] == [
        "solve_s.host_bound", "outer_iters", "k1_launches_per_iter",
        "k1_roofline", "k2_roofline", "device_idle",
        "collective_ms_per_iter", "collective_calls_per_iter"]
    # the repository's own BENCHMARK.json maps to the same tiny benchmark
    assert tiny == registry.load_benchmark(make_root(str(tmp_path / "r")))


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(
        ["schwarz_tpu_torch", "schwarz_tpu_torch.ras", "jaxtyping", "numpy",
         "jax", "jaxlib.xla", "flax.linen", "schwarz_tpu",
         "schwarz_tpu.ops"]) == ["flax.linen", "jax", "jaxlib.xla",
                                 "schwarz_tpu", "schwarz_tpu.ops"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_sources_import_no_jax():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] in ("numpy", "scipy", "math",
                                          "__future__"), (path, name)


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys; from portbench import run; "
        f"run.run_cell('tiny_direct.rhs_stream', 3, 0.2, True, "
        f"root={tiny_root!r}, device='cpu'); "
        "print(run.forbidden_modules(), 'schwarz_tpu_torch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"
