"""The host side of the port's 2-D block-grid free-running tier against the
JAX package's, on the CPU: ``build_async_plan_2d``, its gates, the rank
tiling and the solver's argument checks.  No kernel runs here;
tests/test_torch_async2d_ras.py runs the rounds."""

import numpy as np
import pytest
import scipy.sparse as sp

import schwarz_tpu.models as jmodels
import schwarz_tpu.models.fem as jfem
from schwarz_tpu.exceptions import NotImplementedFeature as JNIF
from schwarz_tpu.ops import async_ras_2d as j2d
import schwarz_tpu_torch
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.models.fem as tfem
from schwarz_tpu_torch.exceptions import NotImplementedFeature as TNIF
from schwarz_tpu_torch.ops import async_ras_2d as t2d
from schwarz_tpu_torch.ras import free_running_tier, make_free_running_solver

OPERATORS = {
    "lap16": (lambda m, f: m.laplacian_2d(16), 2, 2),
    "lap40": (lambda m, f: m.laplacian_2d(40), 2, 4),
    "aniso24": (lambda m, f: f.anisotropic_diffusion_2d(24, eps=5.0,
                                                        theta=0.3), 2, 2),
    "adv16": (lambda m, f: f.advection_diffusion_2d(16), 2, 2),
}


@pytest.mark.parametrize("oras", [0.0, -0.8])
@pytest.mark.parametrize("name", list(OPERATORS))
def test_plan_2d_identical(name, oras):
    """Every plan field bit-identical, the roundings included."""
    make, px, py = OPERATORS[name]
    jm, tm = make(jmodels, jfem), make(tmodels, tfem)
    b = np.random.default_rng(7).standard_normal(jm.n)
    pj = j2d.build_async_plan_2d(jm, b, px, py, oras_weight=oras)
    pt = t2d.build_async_plan_2d(tm, b, px, py, oras_weight=oras)
    for f in ("S", "px", "py", "n", "N", "bx", "by", "Bx", "By"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("coef", "b", "dinv", "mask_dom", "mask_int", "boost"):
        a, c = getattr(pj, f), getattr(pt, f)
        if a is None:
            assert c is None, f
            continue
        assert a.dtype == c.dtype and a.shape == c.shape, f
        np.testing.assert_array_equal(a, c, err_msg=f)
    assert (pt.boost is not None) == bool(oras)
    assert pt.coef[:, 5:].any() == (name == "aniso24")   # 9-point or 5


def test_halo_tile_constants():
    assert (t2d.HX, t2d.HY) == (j2d.HX, j2d.HY) == (64, 8)


def _gate_matrix(case):
    if case == "not_square":
        return sp.eye(12).tocsr()
    if case == "off_stencil":
        # bandwidth-2 couplings are outside any grid stencil
        return sp.diags([1.0, -4.0, 1.0], [-2, 0, 2], shape=(16, 16),
                        format="csr")
    if case == "crosses_rows":
        # a +-1 coupling that wraps from the end of one grid row to the
        # start of the next
        return sp.diags([-np.ones(15), 4.0 * np.ones(16), -np.ones(15)],
                        [-1, 0, 1]).tocsr()
    return jmodels.laplacian_2d(16).to_scipy()


@pytest.mark.parametrize("case,exc,match", [
    ("not_square", (JNIF, TNIF), "not a perfect square"),
    ("off_stencil", (JNIF, TNIF), "9-point grid sparsity"),
    ("crosses_rows", (JNIF, TNIF), "couplings cross grid rows"),
    ("oras_positive", (ValueError, ValueError), "outside"),
    ("oras_below", (ValueError, ValueError), "outside"),
])
def test_plan_2d_gates_raise_alike(case, exc, match):
    M = _gate_matrix(case)
    oras = {"oras_positive": 0.8, "oras_below": -1.5}.get(case, 0.0)
    b = np.ones(M.shape[0])
    with pytest.raises(exc[0], match=match) as ej:
        j2d.build_async_plan_2d(jmodels.CSRMatrix.from_scipy(M), b, 2, 2,
                                oras_weight=oras)
    with pytest.raises(exc[1], match=match) as et:
        t2d.build_async_plan_2d(tmodels.CSRMatrix.from_scipy(M), b, 2, 2,
                                oras_weight=oras)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("D,px,py", [
    (1, 2, 2), (2, 2, 2), (4, 2, 2), (3, 2, 2), (8, 4, 2), (4, 4, 2),
    (2, 4, 2), (4, 4, 4), (8, 4, 4), (16, 4, 4), (6, 6, 2), (5, 4, 4),
    (12, 6, 4), (2, 1, 4),
])
def test_device_grid_matches(D, px, py):
    assert t2d._device_grid(D, px, py) == j2d._device_grid(D, px, py)


def _lap(n=16):
    A = tmodels.laplacian_2d(n)
    return A, tmodels.generate_rhs(A.n, random=False)


@pytest.mark.parametrize("D,grid,windows,perm", [
    (None, (4, 2), (1, 1), list(range(8))),
    (8, (4, 2), (1, 1), list(range(8))),
    (4, (2, 2), (1, 2), [0, 1, 2, 3, 4, 5, 6, 7]),
    (2, (2, 1), (2, 2), [0, 1, 4, 5, 2, 3, 6, 7]),
    (1, (1, 1), (2, 4), list(range(8))),
])
def test_rank_tiling_and_block_permutation(D, grid, windows, perm):
    """(pdx, pdy), (ply, plx) and the stacked-block order of the JAX
    package (``schwarz_tpu/ops/async_ras_2d.py:698-708``)."""
    A, b = _lap()
    s = t2d.AsyncRASolver2D(A, b, px=4, py=2, num_ranks=D, device="cpu")
    assert (s.pdx, s.pdy) == grid and (s.ply, s.plx) == windows
    assert s._perm.tolist() == perm
    assert s.D == (8 if D is None else D)
    X = np.arange(8 * s.plan.By * s.plan.Bx, dtype=np.float32).reshape(
        8, s.plan.By, s.plan.Bx)
    import torch

    folded = s._fold(torch.from_numpy(X))
    assert folded.shape == (s.D, s.ply * s.plan.By, s.plx * s.plan.Bx)
    np.testing.assert_array_equal(s._unfold(folded).numpy(), X)
    # window (iy, ix) of rank d sits at rows iy*By, columns ix*Bx
    d, iy, ix = s.D - 1, s.ply - 1, s.plx - 1
    np.testing.assert_array_equal(
        folded[d, iy * s.plan.By:(iy + 1) * s.plan.By,
               ix * s.plan.Bx:(ix + 1) * s.plan.Bx].numpy(), X[-1])


def test_solver_2d_argument_checks():
    A, b = _lap()
    with pytest.raises(ValueError, match="cannot tile the 2 x 2 block grid"):
        t2d.AsyncRASolver2D(A, b, 2, 2, num_ranks=3, device="cpu")
    with pytest.raises(TNIF, match=r"fixed \(63, 7\)-cell overlap"):
        t2d.AsyncRASolver2D(A, b, 2, 2, overlap=8, device="cpu")
    with pytest.raises(JNIF, match=r"fixed \(63, 7\)-cell overlap"):
        j2d.AsyncRASolver2D(jmodels.laplacian_2d(16), b, 2, 2, overlap=8)
    assert t2d.AsyncRASolver2D(A, b, 2, 2, overlap=7, device="cpu").D == 4
    s = t2d.AsyncRASolver2D(A, b, 2, 2, device="cpu")
    # two-level refinement: a host coarse correction before each launch
    x, info = s.run_refined(tol=1e-8, coarse_q=4)
    assert info["converged"] and info["relative_residual_norm"] <= 1e-8


def test_more_ranks_than_gossip_lanes_raise():
    """One gossip lane per rank: 130 blocks need ``num_ranks``."""
    A = tmodels.laplacian_2d(16)
    b = np.ones(A.n)
    with pytest.raises(ValueError, match="gossip"):
        t2d.AsyncRASolver2D(A, b, px=65, py=2, device="cpu")
    assert t2d.AsyncRASolver2D(A, b, px=65, py=2, num_ranks=65,
                               device="cpu").ply == 2


def test_solver_2d_default_device_needs_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = _lap()
    with pytest.raises(RuntimeError, match="CUDA"):
        t2d.AsyncRASolver2D(A, b, 2, 2)


def test_package_exports_2d_tier():
    assert schwarz_tpu_torch.AsyncRASolver2D is t2d.AsyncRASolver2D
    assert schwarz_tpu_torch.build_async_plan_2d is t2d.build_async_plan_2d
    assert tmodels.anisotropic_diffusion_2d is tfem.anisotropic_diffusion_2d


@pytest.mark.parametrize("kind,S,kw,cls", [
    ("lap", 4, {}, "AsyncRASolver2D"),
    ("lap", 8, {}, "AsyncRASolver2D"),
    ("aniso", 4, dict(overlap=3), "AsyncRASolver2D"),
    ("lap64", 4, dict(overlap=8), "AsyncRASolver"),    # falls to the 1-D tier
    ("lap", 2, {}, "AsyncRASolver"),                   # no px x py grid
])
def test_dispatch_builds_the_tier(kind, S, kw, cls):
    A = {"lap": lambda: tmodels.laplacian_2d(16),
         "lap64": lambda: tmodels.laplacian_2d(64),
         "aniso": lambda: tfem.anisotropic_diffusion_2d(16)}[kind]()
    st = tcfg.Settings(free_running=True, tolerance=1e-3, **kw)
    solver, refine = make_free_running_solver(A, np.ones(A.n), S, st,
                                              device="cpu")
    assert type(solver).__name__ == cls and not refine
    tier = free_running_tier(A, S, st)
    assert tier == {"AsyncRASolver2D": "2d", "AsyncRASolver": "1d"}[cls]
    if cls == "AsyncRASolver2D":
        py = max(d for d in range(2, int(S ** 0.5) + 1) if S % d == 0)
        assert (solver.plan.px, solver.plan.py) == (S // py, py)
        assert solver.D == S


def test_dispatch_num_ranks_that_cannot_tile_falls_to_1d():
    """As in the JAX package, where a mesh that cannot tile the block grid
    makes the chain fall through to the 1-D tier."""
    A = tmodels.laplacian_2d(16)
    st = tcfg.Settings(free_running=True, tolerance=1e-3)
    assert free_running_tier(A, 6, st, num_ranks=6) == "2d"
    assert free_running_tier(A, 6, st, num_ranks=4) == "1d"


def test_dispatch_general_tier_still_raises():
    """A custom partition, once refused, builds the general-graph tier."""
    A = tmodels.laplacian_2d(16)
    part = (np.arange(A.n) * 4 // A.n).astype(np.int64)
    solver, refine = make_free_running_solver(
        A, np.ones(A.n), 4, tcfg.Settings(free_running=True, tolerance=1e-4),
        partition_indices=part, device="cpu")
    assert type(solver).__name__ == "AsyncGeneralRASolver" and not refine
    assert free_running_tier(A, 4, tcfg.Settings(free_running=True),
                             partition_indices=part) == "general"
    np.testing.assert_array_equal(np.bincount(part), solver.plan.n_int)
