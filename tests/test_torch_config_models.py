"""The port's configuration and models against the JAX package's, plus the
port's import isolation and device rules."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch import Settings
from schwarz_tpu_torch.ras import solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return None   # a required field


def _fields(cls):
    return [(f.name, _default(f)) for f in dataclasses.fields(cls)]


def _normalize(v):
    return (type(v).__name__, v.value) if hasattr(v, "value") else v


@pytest.mark.parametrize("name", ["Settings", "CommSettings",
                                  "ConvergenceSettings", "Metadata"])
def test_dataclass_fields_and_defaults_equal(name):
    jf, tf = _fields(getattr(jcfg, name)), _fields(getattr(tcfg, name))
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if dataclasses.is_dataclass(jd):
            assert [(f, _normalize(x)) for f, x in _fields(type(jd))] == [
                (f, _normalize(x)) for f, x in _fields(type(td))], n
        else:
            assert _normalize(jd) == _normalize(td), n


@pytest.mark.parametrize("name", ["Partition", "LocalSolver", "Precond",
                                  "HaloStrategy", "GlobalConvergence",
                                  "LocalCriterion"])
def test_enums_equal(name):
    assert [(m.name, m.value) for m in getattr(jcfg, name)] == [
        (m.name, m.value) for m in getattr(tcfg, name)]


@pytest.mark.parametrize("dtype,halo", [("float64", None),
                                        ("float32", None),
                                        ("float64", "float32")])
def test_value_dtypes_are_torch(dtype, halo):
    js = jcfg.Settings(dtype=dtype, halo_dtype=halo)
    ts = tcfg.Settings(dtype=dtype, halo_dtype=halo)
    assert ts.value_dtype == getattr(torch, str(js.value_dtype))
    assert ts.halo_value_dtype == getattr(torch, str(js.halo_value_dtype))
    assert ts.replace(overlap=5).overlap == 5


@pytest.mark.parametrize("n", [1, 2, 5, 12, 33])
def test_laplacian_identical(n):
    a, b = jmodels.laplacian_2d(n), tmodels.laplacian_2d(n)
    assert a.n == b.n
    for f in ("row_ptrs", "col_idxs", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("random,seed", [(True, 0), (True, 7), (False, 0)])
def test_rhs_identical(random, seed):
    np.testing.assert_array_equal(
        jmodels.generate_rhs(100, random=random, seed=seed),
        tmodels.generate_rhs(100, random=random, seed=seed))


@pytest.mark.parametrize("name", ["ani3_crop.mtx", "ani4_crop.mtx"])
def test_read_mtx_identical(name):
    a = jmodels.read_mtx(jmodels.matrix_path(name))
    b = tmodels.read_mtx(tmodels.matrix_path(name))
    for f in ("row_ptrs", "col_idxs", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_mtx_round_trip(tmp_path):
    a = tmodels.laplacian_2d(6)
    p = str(tmp_path / "a.mtx")
    tmodels.write_mtx(p, a)
    b = tmodels.read_mtx(p)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.col_idxs, b.col_idxs)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, schwarz_tpu_torch\n"
        "for m in pkgutil.walk_packages(schwarz_tpu_torch.__path__, "
        "'schwarz_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'schwarz_tpu' or "
        "k.startswith('schwarz_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_solve_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = tmodels.laplacian_2d(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve(A, tmodels.generate_rhs(A.n), Settings(), 2)


@pytest.mark.parametrize("kw", [
    # settings that were unported before the local solvers, the Krylov
    # acceleration, overlap_split, dia_only and the checkpoints were; each
    # case now holds the port to what the JAX package does with them
    dict(two_level=True, local_solver=tcfg.LocalSolver.iterative_gmres),
    dict(oras_weight="auto", comm=tcfg.CommSettings(overlap_split=True)),
    dict(oras_weight=-0.5, local_solver=tcfg.LocalSolver.direct_cholesky),
    dict(local_solver=tcfg.LocalSolver.iterative_gmres),
    dict(local_solver=tcfg.LocalSolver.direct_cholesky),
    dict(precond=tcfg.Precond.fsai, inner_operator="dia_only"),
    dict(accelerator="fgmres"),
    # a free-running metis partition reaches the general-graph tier (K7),
    # which has no fresh_read
    dict(free_running=True, num_subdomains=4,
         partition=tcfg.Partition.metis,
         comm=tcfg.CommSettings(fresh_read=True)),
    dict(comm=tcfg.CommSettings(overlap_split=True)),
    dict(comm=tcfg.CommSettings(strategy=tcfg.HaloStrategy.rdma,
                                stage_through_host=True)),
    dict(local_solver=tcfg.LocalSolver.direct_lu),
    # (blocks of 8: the default 16 does not divide the 40 padded rows,
    # which the port refuses with a ValueError and the JAX package with an
    # AssertionError, before either reaches FGMRES)
    dict(precond=tcfg.Precond.block_jacobi, accelerator="fgmres",
         block_jacobi_block_size=8),
    # the free-running kernels run Jacobi-preconditioned local solves only
    dict(partition=tcfg.Partition.metis, free_running=True, two_level=True,
         precond=tcfg.Precond.fsai),
    dict(inner_operator="dia_only"),
    dict(halo_dtype="float32", write_debug_out=True),
])
def test_unported_settings_raise(kw, tmp_path, monkeypatch):
    """Each setting does in the port what it does in the JAX package: the
    same error class where the JAX package refuses it (O-RAS with
    ``overlap_split``, ``dia_only`` with the solution-based criterion, the
    free-running kernels' limits, host staging), else a solve with the
    same outcome and iteration count."""
    from schwarz_tpu.ras import solve as jsolve

    monkeypatch.chdir(tmp_path)     # write_debug_out writes to the cwd
    kw = dict(kw)
    S = kw.pop("num_subdomains", 2)
    A = tmodels.laplacian_2d(8)
    b = tmodels.generate_rhs(A.n)
    jkw = {k: (getattr(jcfg, type(v).__name__)(v.value)
               if hasattr(v, "value") else v) for k, v in kw.items()}
    if "comm" in kw:
        jkw["comm"] = jcfg.CommSettings(**{
            f.name: (getattr(jcfg, type(v).__name__)(v.value)
                     if hasattr(v, "value") else v)
            for f in dataclasses.fields(kw["comm"])
            for v in [getattr(kw["comm"], f.name)]})
    try:
        rj = jsolve(A, b, jcfg.Settings(**jkw), S)
    except Exception as e:      # the JAX package refuses: so must the port
        with pytest.raises(Exception) as got:
            solve(A, b, Settings(**kw), S, device="cpu")
        assert type(got.value).__name__ == type(e).__name__, got.value
        return
    rt = solve(A, b, Settings(**kw), S, device="cpu")
    assert (rt.converged, rt.iters) == (rj.converged, rj.iters)
    np.testing.assert_allclose(rt.relative_residual_norm,
                               rj.relative_residual_norm, rtol=1e-5)
    if kw.get("write_debug_out"):
        assert (tmp_path / "schwarz_debug_out.npz").exists()
