"""Discovery by name: a new configuration, traffic mix and metric are
found from their files and the new ``BENCHMARK.json`` entries, with no
edit to any file that was there, the CPU tests' own files included; and
nothing the benchmark runs imports JAX or the JAX package."""

from __future__ import annotations

import ast
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import control, registry, run
from portbench.conftest import (HERE, ROOT, load, make_root, pending,
                                tiny_cells, tiny_file, write)

# the pending cell of the configuration across a process group
GROUP_CONFIG = "flagship_lap2d_512_4proc"


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
    """Every cell of BENCHMARK.json, and each pending cell of a tiny file
    (the group configuration's), has a tiny cell of the same chips and
    processes."""
    bench = registry.load_benchmark(ROOT)
    tiny = registry.load_benchmark(tiny_root)
    real = bench["workloads"] + [
        {"name": f"{config}.{p['traffic']}", "config": config,
         "chips": p["chips"]} for config, p in pending(bench)]
    assert GROUP_CONFIG in [c["config"] for c in real]
    assert len(tiny["workloads"]) == len(real)
    for cell, small in zip(real, tiny["workloads"]):
        assert small["chips"] == cell["chips"]
        assert small["config"] == tiny_file(cell["config"])["name"]
        assert registry.config(tiny_root, small["config"]).get(
            "processes", 1) == registry.config(ROOT, cell["config"]).get(
            "processes", 1)
    assert [c["name"] for c in tiny["workloads"]] == [
        name for name, _, _ in tiny_cells()]
    assert [m["name"] for m in registry.cell_metrics(
        tiny, "tiny_flagship_4proc.rhs_stream", True)] == [
        "solve_s.host_bound", "outer_iters", "k1_launches_per_iter",
        "k1_roofline", "k2_roofline", "device_idle",
        "collective_ms_per_iter", "collective_calls_per_iter"]
    for m in tiny_file(GROUP_CONFIG)["pending"]["per_layer"]:
        assert callable(registry.reader(ROOT, m["name"]))


def test_tiny_root_maps_the_group_cell_once(tmp_path):
    """With the group cell and the mesh metrics entered in
    ``BENCHMARK.json``, as a later PR enters them, each is mapped once."""
    bench = registry.load_benchmark(ROOT)
    p = tiny_file(GROUP_CONFIG)["pending"]
    cell = {"name": f"{GROUP_CONFIG}.{p['traffic']}", "config": GROUP_CONFIG,
            "traffic": p["traffic"], "chips": p["chips"],
            "why": "the flagship over 4 processes"}
    bench["workloads"].append(cell)
    for m in bench["per_layer"]:
        if m["name"] in p["reports"]:
            m["workloads"].append(cell["name"])
    bench["per_layer"] += [dict(m, workloads=[cell["name"]])
                           for m in p["per_layer"]]
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


# a test-only operator kind: sized by nx, ny and nz, not by n
LAPLACIAN_3D7 = '''"""The 3-D 7-point Laplacian on an nx x ny x nz grid, x fastest."""

import numpy as np
import scipy.sparse as sp


def _line(n):
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1])


def build(spec):
    nx, ny, nz = (int(spec[k]) for k in ("nx", "ny", "nz"))
    eye = sp.identity
    A = (sp.kron(eye(ny * nz), _line(nx))
         + sp.kron(sp.kron(eye(nz), _line(ny)), eye(nx))
         + sp.kron(_line(nz), eye(nx * ny))).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return A
'''


def _tree(tmp_path):
    """A copy of the repository's ``BENCHMARK.json`` and ``portbench/``
    under ``tmp_path``, and the copy's own ``conftest`` module, whose
    ``make_root`` and ``tiny_cells`` read the copy."""
    tree = tmp_path / "tree"
    shutil.copytree(HERE, tree / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tree)
    spec = importlib.util.spec_from_file_location(
        "tree_conftest", tree / "portbench" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return str(tree), mod


def _add_configuration(tree: str, name: str, tiny: dict = None) -> str:
    """A configuration ``name`` of the flagship's recipe, its tiny file
    when ``tiny`` is given, and its cell appended to the tree's
    ``BENCHMARK.json``; returns the cell's name."""
    cfg = load("portbench/configs/flagship_lap2d_512.json")
    cfg.update(name=name, source="a test", reduced={})
    write(os.path.join(tree, "portbench", "configs", f"{name}.json"), cfg)
    if tiny is not None:
        write(os.path.join(tree, "portbench", "tiny", f"{name}.json"), tiny)
    path = os.path.join(tree, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    cell = f"{name}.rhs_stream"
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "rhs_stream", "chips": 1,
                               "why": "a later configuration"})
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return cell


def _collected(tree: str, *files) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree, ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", *files], cwd=tree, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return {line.split("::", 1)[1] for line in p.stdout.splitlines()
            if "::" in line}


def test_new_configuration_takes_no_edit(tmp_path):
    """A configuration of an operator kind the benchmark does not have,
    added to a copy of the whole tree by files and appended entries
    alone, gets a tiny cell that runs correct on the CPU, faces the
    control, the faults and the card tests, and fails its control; no
    file that was there changes, ``conftest.py`` and the tests
    included."""
    tree, mod = _tree(tmp_path)
    before = _digests(tree)
    with open(os.path.join(tree, "BENCHMARK.json")) as f:
        old = json.load(f)
    pb = os.path.join(tree, "portbench")
    with open(os.path.join(pb, "operators", "laplacian_3d7_test.py"),
              "w") as f:
        f.write(LAPLACIAN_3D7)
    with open(os.path.join(pb, "metrics", "later_set_rhs_share.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    return 100 * sum(s.set_rhs_s for s in ctx.solves) / "
                "ctx.window_s\n")
    cell = _add_configuration(tree, "later_lap3d", tiny={
        "name": "tiny_later_lap3d", "operator": {"nx": 6, "ny": 5, "nz": 8},
        "num_subdomains": 4,
        "settings": {"coarse_aggregates": 4, "overlap": 2}})
    cfg_path = os.path.join(pb, "configs", "later_lap3d.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["operator"] = {"kind": "laplacian_3d7_test", "nx": 64, "ny": 64,
                       "nz": 64}
    write(cfg_path, cfg)
    with open(os.path.join(tree, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "later_set_rhs_share", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "entry point",
                               "moves": "solve_s.p90", "workloads": [cell]})
    write(os.path.join(tree, "BENCHMARK.json"), bench)

    root = mod.make_root(str(tmp_path / "tiny"))
    small = "tiny_later_lap3d.rhs_stream"
    tiny = registry.load_benchmark(root)
    names = [c["name"] for c in tiny["workloads"]]
    assert sorted(names) == sorted(
        [name for name, _, _ in tiny_cells()] + [small])
    assert [name for name, _, _ in mod.tiny_cells()] == names
    got = registry.config(root, "tiny_later_lap3d")
    assert got["operator"] == {"kind": "laplacian_3d7_test", "nx": 6,
                               "ny": 5, "nz": 8}
    assert got["num_subdomains"] == 4
    assert [m["name"] for m in registry.cell_metrics(tiny, small, True)] \
        == ["later_set_rhs_share"]
    out = run.run_cell(small, 2**31 + 13, 0.3, True, root=root,
                       device="cpu")["result"]
    assert out["correct"] is True and out["failed"] == 0
    assert 0 < out["metrics"]["later_set_rhs_share"]["value"] < 100
    res = control.control(small, 2**31 + 99, 0.2, root=root, device="cpu")
    assert res["correct"] is False and res["failed"] >= 1

    ids = _collected(tree, "portbench/test_portbench_control.py",
                     "portbench/test_portbench_cuda.py")
    for want in (f"test_control_is_not_correct[{small}]",
                 f"test_fault_is_not_correct[{small}-step_unchanged]",
                 f"test_fault_is_not_correct[{small}-answer_altered]",
                 f"test_traced_run_on_the_card[{small}]",
                 f"test_control_on_the_card[{small}]"):
        assert want in ids, want

    after = _digests(tree)
    changed = [p for p, h in before.items()
               if after.get(p) != h and not p.endswith("BENCHMARK.json")]
    assert changed == []
    # BENCHMARK.json: its entries as they were, the new ones appended
    for key, value in old.items():
        if isinstance(value, list):
            assert bench[key][:len(value)] == value, key
        else:
            assert bench[key] == value, key


def test_configuration_without_tiny_file(tmp_path):
    """A configuration with no tiny file stops the CPU tests with an
    error that names the file to add."""
    tree, mod = _tree(tmp_path)
    _add_configuration(tree, "later_no_tiny")
    want = re.escape("add portbench/tiny/later_no_tiny.json")
    with pytest.raises(FileNotFoundError, match=want):
        mod.make_root(str(tmp_path / "tiny"))
    with pytest.raises(FileNotFoundError, match=want):
        mod.tiny_cells()


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
