"""The port's free-running host side against the JAX package's, on the CPU:
the FEM generators, the 1-D tier's plan (``build_async_plan``), its gates,
and the tier the free-running dispatch chain picks.  No kernel runs here;
tests/test_torch_async_ras.py runs the rounds."""

import numpy as np
import pytest
import scipy.sparse as sp

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
import schwarz_tpu.models.fem as jfem
from schwarz_tpu.exceptions import NotImplementedFeature as JNIF
from schwarz_tpu.ops.async_ras import build_async_plan as jplan
from schwarz_tpu.ops.async_ras import AsyncRASolver as JAsync
from schwarz_tpu.ops.async_ras_2d import AsyncRASolver2D as JAsync2D
from schwarz_tpu.ops.async_ras_general import AsyncGeneralRASolver as JGen
from schwarz_tpu.ras import make_free_running_solver as jmake
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.models.fem as tfem
from schwarz_tpu_torch.exceptions import NotImplementedFeature as TNIF
from schwarz_tpu_torch.ops.async_ras import build_async_plan as tplan
from schwarz_tpu_torch.ras import free_running_tier, make_free_running_solver


def _same_csr(a, b):
    assert a.n == b.n
    for f in ("row_ptrs", "col_idxs", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("name,args,kw", [
    ("anisotropic_diffusion_2d", (9,), {}),
    ("anisotropic_diffusion_2d", (12,), dict(eps=10.0, theta=0.3)),
    ("laplacian_3d", (5,), {}),
    ("laplacian_3d", (12,), dict(dtype=np.float32)),
    ("helmholtz_2d", (10,), dict(k=7.0)),
    ("advection_diffusion_2d", (16,), {}),
    ("advection_diffusion_2d", (11,), dict(peclet=2000.0, bx=1.0, by=0.3,
                                           upwind=False)),
])
def test_fem_identical(name, args, kw):
    _same_csr(getattr(jfem, name)(*args, **kw), getattr(tfem, name)(*args, **kw))


def test_models_export_fem():
    assert tmodels.laplacian_3d is tfem.laplacian_3d
    assert tmodels.advection_diffusion_2d is tfem.advection_diffusion_2d


def _banded_spd(seed):
    """A random banded SPD matrix with an asymmetric offset set (the JAX
    package's tests/test_async_ras.py random banded case)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 500))
    offs = sorted(set([0] + rng.integers(-12, 13, size=4).tolist()))
    rows, cols, vals = [], [], []
    for o in offs:
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
        vals.append(rng.uniform(0.1, 1.0, i.size) * (-1 if o else 1))
    M = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    M = 0.5 * (M + M.T)
    M = M + sp.diags(np.abs(M).sum(axis=1).A1 + 0.5)
    return M.tocsr(), rng.standard_normal(n)


def _pair(kind):
    """(JAX matrix, port matrix, rhs) for one named operator."""
    if kind == "banded":
        M, b = _banded_spd(3)
        return (jmodels.CSRMatrix.from_scipy(M),
                tmodels.CSRMatrix.from_scipy(M), b)
    name, n = kind.split(":")
    n = int(n)
    jm = {"lap2": jmodels.laplacian_2d, "lap3": jfem.laplacian_3d}[name](n)
    tm = {"lap2": tmodels.laplacian_2d, "lap3": tfem.laplacian_3d}[name](n)
    return jm, tm, jmodels.generate_rhs(jm.n, seed=5)


@pytest.mark.parametrize("oras", [0.0, -0.5])
@pytest.mark.parametrize("kind,S,overlap", [
    ("lap2:16", 4, 2), ("lap2:16", 8, 2), ("lap3:12", 2, 2),
    ("lap3:12", 4, 2), ("banded", 2, 3), ("banded", 4, 1),
])
def test_plan_identical(kind, S, overlap, oras):
    """Every plan field bit-identical, the roundings included."""
    jm, tm, b = _pair(kind)
    pj = jplan(jm, b, S, overlap, oras_weight=oras)
    pt = tplan(tm, b, S, overlap, oras_weight=oras)
    for f in ("S", "N", "R", "hw", "ovp", "total", "offsets"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("dia", "b", "dinv", "mask_dom", "mask_int", "boost"):
        a, c = getattr(pj, f), getattr(pt, f)
        if a is None:
            assert c is None, f
            continue
        assert a.dtype == c.dtype and a.shape == c.shape, f
        np.testing.assert_array_equal(a, c, err_msg=f)
    assert (pt.boost is not None) == bool(oras)


def _unstructured(n=64):
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, n, size=3 * n)
    m = sp.coo_matrix((rng.standard_normal(3 * n), (rows, cols)),
                      shape=(n, n)).tocsr() + sp.eye(n) * 10
    return m.tocsr()


def _no_main_diagonal(n=300):
    return sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1]).tocsr()


@pytest.mark.parametrize("case,exc", [
    ("unstructured", (JNIF, TNIF)),          # > 16 diagonals
    ("no_main_diagonal", (JNIF, TNIF)),
    ("halo_too_wide", (JNIF, TNIF)),         # hw > R
    ("oras_positive", (ValueError, ValueError)),
    ("oras_below", (ValueError, ValueError)),
])
def test_plan_gates_raise_alike(case, exc):
    S, overlap, oras = 4, 2, 0.0
    if case == "unstructured":
        M = _unstructured()
    elif case == "no_main_diagonal":
        M = _no_main_diagonal()
    elif case == "halo_too_wide":
        M, S = jfem.laplacian_3d(12).to_scipy(), 8
    else:
        M = jmodels.laplacian_2d(16).to_scipy()
        oras = 0.8 if case == "oras_positive" else -1.5
    b = np.ones(M.shape[0])
    with pytest.raises(exc[0]):
        jplan(jmodels.CSRMatrix.from_scipy(M), b, S, overlap, oras_weight=oras)
    with pytest.raises(exc[1]):
        tplan(tmodels.CSRMatrix.from_scipy(M), b, S, overlap,
              oras_weight=oras)


def _jax_tier(solver) -> str:
    return {JAsync2D: "2d", JAsync: "1d", JGen: "general"}[type(solver)]


@pytest.mark.parametrize("kind,S,kw", [
    ("lap2:8", 4, {}),                       # square 5-point grid: 2-D tier
    ("lap2:16", 2, {}),                      # S = 2 has no px x py grid
    ("lap2:16", 4, dict(overlap=8)),         # beyond the 2-D halo tile
    ("lap3:12", 4, {}),                      # +-n^2 offsets: not a 2-D grid
    ("aniso:16", 4, dict(overlap=3)),        # 9-point stencil: 2-D tier
    ("banded", 2, {}),
    ("lap3:12", 8, {}),                      # halo wider than the interior
    ("lap2:16", 4, dict(partition_indices=True)),  # custom partition
])
def test_dispatch_tier_matches(kind, S, kw):
    """The tier of the JAX dispatch chain (the class it builds, on the CPU
    mesh) is the tier the port picks for the same operator, S and overlap."""
    kw = dict(kw)
    if kind == "aniso:16":
        jm, tm = jfem.anisotropic_diffusion_2d(16), tfem.anisotropic_diffusion_2d(16)
        b = np.ones(jm.n)
    else:
        jm, tm, b = _pair(kind)
    part = None
    if kw.pop("partition_indices", False):
        part = (np.arange(jm.n) * S // jm.n).astype(np.int64)
    js = jcfg.Settings(free_running=True, tolerance=1e-4, **kw)
    ts = tcfg.Settings(free_running=True, tolerance=1e-4, **kw)
    solver, _ = jmake(jm, b, S, js, partition_indices=part)
    assert free_running_tier(tm, S, ts, partition_indices=part) == \
        _jax_tier(solver)


@pytest.mark.parametrize("kind,S,kw", [
    ("lap2:8", 4, dict(partition=tcfg.Partition.metis)),   # honoured by K7 only
    ("lap3:12", 8, {}),
])
def test_unported_tiers_raise(kind, S, kw):
    """What the 2-D and 1-D tiers refuse builds the general tier, as in the
    JAX package; ``fresh_read`` there raises with its message."""
    jm, tm, b = _pair(kind)
    jkw = {k: jcfg.Partition(v.value) for k, v in kw.items()}
    js = jcfg.Settings(free_running=True, tolerance=1e-4, **jkw)
    ts = tcfg.Settings(free_running=True, tolerance=1e-4, **kw)
    jsolver, _ = jmake(jm, b, S, js)
    solver, refine = make_free_running_solver(tm, b, S, ts, device="cpu")
    assert type(solver).__name__ == type(jsolver).__name__ == \
        "AsyncGeneralRASolver"
    assert not refine and solver.plan.S == S
    for f in ("Rint", "H", "SEG", "C"):
        assert getattr(solver.plan, f) == getattr(jsolver.plan, f)
    with pytest.raises(TNIF, match="fresh_read") as te:
        make_free_running_solver(tm, b, S, ts, fresh_read=True, device="cpu")
    with pytest.raises(JNIF) as je:
        jmake(jm, b, S, js, fresh_read=True)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(accelerator="fgmres"),
    dict(precond=tcfg.Precond.block_jacobi),
])
def test_free_running_setting_checks(kw):
    A = tmodels.laplacian_2d(16)
    with pytest.raises(TNIF):
        make_free_running_solver(A, np.ones(A.n), 2,
                                 tcfg.Settings(free_running=True, **kw),
                                 device="cpu")
    with pytest.raises(ValueError, match="oras_weight"):
        make_free_running_solver(A, np.ones(A.n), 2,
                                 tcfg.Settings(free_running=True,
                                               oras_weight="x"),
                                 device="cpu")
