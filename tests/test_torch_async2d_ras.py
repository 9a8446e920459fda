"""The port's free-running asynchronous RAS on 2-D block grids (K6) against
the JAX package's, on the CPU.

JAX runs ``AsyncRASolver2D`` on the 8-device CPU mesh with its Pallas kernel
in interpret mode; the port runs K6's plain PyTorch version, a lockstep
emulation of the free-running ranks.  Both sides get the same explicit rank
count: the result depends on it (halos between a rank's own windows refresh
with no lag, halos between ranks with lag B).  Without ``fresh_read`` the
rounds do not depend on timing, so both must agree up to float32 sums in
another order: the iterate within 1e-4 * max|x| on owned cells and on the
halo cells of the solve domain, and ``done_at``, ``rounds`` and the known
bits equal.  Each JAX configuration compiles for 6-12 s, so each runs once.
"""

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as spla

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
import schwarz_tpu.models.fem as jfem
from schwarz_tpu.ops.async_ras_2d import AsyncRASolver2D as J2D
from schwarz_tpu.parallel.mesh import make_mesh
import schwarz_tpu.ras as jras
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.models.fem as tfem
from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
import schwarz_tpu_torch.ras as tras

BAR = 1e-4        # x within BAR * max|x|: float32 sums in another order

OPERATORS = {
    "lap16": lambda m, f: m.laplacian_2d(16),
    "lap256": lambda m, f: m.laplacian_2d(256),
    "adv16": lambda m, f: f.advection_diffusion_2d(16),
    "aniso24": lambda m, f: f.anisotropic_diffusion_2d(24, eps=5.0,
                                                       theta=0.3),
}

# name: (operator, px, py, D, rounds, solver keywords)
CASES = {
    "D4": ("lap16", 2, 2, 4, 20, dict(tolerance=1e-3, ninner=8)),
    "D1-folded": ("lap16", 2, 2, 1, 8, dict(tolerance=1e-3, ninner=8)),
    "D2": ("lap16", 2, 2, 2, 20, dict(tolerance=1e-3, ninner=8)),
    "B2": ("lap16", 2, 2, 4, 24, dict(tolerance=1e-3, ninner=8,
                                      staleness=2)),
    "oras": ("lap16", 2, 2, 4, 20, dict(tolerance=1e-3, ninner=8,
                                        oras_weight=-0.8)),
    "bicgstab": ("adv16", 2, 2, 4, 20, dict(tolerance=1e-3, ninner=8,
                                            nonsym=True)),
    "9-point": ("aniso24", 2, 2, 4, 20, dict(tolerance=1e-3, ninner=8)),
    "x-split": ("lap256", 2, 2, 4, 8, dict(tolerance=1e-3, ninner=8)),
}
CHUNK = 4


def _load(path):
    with np.load(path + ".npz") as f:
        return [f[f"arr_{i}"] for i in range(3)]


@pytest.mark.parametrize("name", list(CASES))
def test_rounds_match_jax(name, tmp_path):
    op, px, py, D, rounds, kw = CASES[name]
    jm = OPERATORS[op](jmodels, jfem)
    tm = OPERATORS[op](tmodels, tfem)
    b = np.random.default_rng(11).uniform(0.5, 1.5, jm.n)
    js = J2D(jm, b, px=px, py=py, chunk_rounds=CHUNK,
             mesh=make_mesh(jax.devices()[:D]), **kw)
    ts = AsyncRASolver2D(tm, b, px=px, py=py, chunk_rounds=CHUNK,
                         num_ranks=D, device="cpu", **kw)
    assert (ts.pdx, ts.pdy, ts.ply, ts.plx) == (js.pdx, js.pdy, js.ply,
                                                js.plx)
    np.testing.assert_array_equal(ts._perm, js._perm)
    ckj, ckt = str(tmp_path / "jax"), str(tmp_path / "torch")
    xj, ij = js.run(max_rounds=rounds, checkpoint_path=ckj)
    xt, it = ts.run(max_rounds=rounds, checkpoint_path=ckt)
    assert it["rounds"] == ij["rounds"] and it["rounds"] >= 2 * CHUNK
    np.testing.assert_array_equal(it["done_at"], ij["done_at"])
    for k in ("converged", "grid", "device_grid", "fresh_read_hits"):
        assert it[k] == ij[k], k
    assert set(it) == set(ij)
    scale = float(np.abs(xj).max())
    assert float(np.abs(xt - xj).max()) <= BAR * scale
    # the carried state: the iterate with its halos, known bits, aux
    (Xj, knj, auxj), (Xt, knt, auxt) = _load(ckj), _load(ckt)
    assert Xt.shape == Xj.shape and Xt.dtype == Xj.dtype
    p = ts.plan
    own = p.mask_int[ts._perm] > 0
    halo = (p.mask_dom[ts._perm] > 0) & ~own
    assert float(np.abs(Xt - Xj)[own].max()) <= BAR * scale
    assert float(np.abs(Xt - Xj)[halo].max()) <= BAR * scale
    assert np.abs(Xj[halo]).max() > 0          # the halos were filled
    np.testing.assert_array_equal(knt, knj)
    np.testing.assert_array_equal(auxt[:, 1:3], auxj[:, 1:3])
    np.testing.assert_allclose(auxt[:, 0], auxj[:, 0], rtol=1e-5)   # rn0


def test_solve_2d_slice_matches_jax(monkeypatch):
    """The slice as a whole: solve(free_running=True) on a 2-D Laplacian
    with a composite subdomain count takes the 2-D tier in both packages
    (4 blocks, 4 ranks on both sides)."""
    built = []
    for mod in (jras, tras):
        def record(*a, _make=mod.make_free_running_solver, **k):
            out = _make(*a, **k)
            built.append(out[0])
            return out
        monkeypatch.setattr(mod, "make_free_running_solver", record)
    A = jmodels.laplacian_2d(16)
    b = np.ones(A.n)
    kw = dict(free_running=True, tolerance=1e-3, overlap=2,
              local_max_iters=8)
    rj = jras.solve(A, b, jcfg.Settings(**kw), num_subdomains=4)
    rt = tras.solve(tmodels.laplacian_2d(16), b, tcfg.Settings(**kw), 4,
                    device="cpu")
    sj, st = built
    assert (type(sj), type(st)) == (J2D, AsyncRASolver2D)
    assert (sj.D, st.D) == (4, 4)
    assert rt.converged and rj.converged
    assert (rt.iters, rt.diverged) == (rj.iters, rj.diverged)
    err = float(np.abs(rt.solution - rj.solution).max())
    assert err <= BAR * float(np.abs(rj.solution).max()), err
    # the true residuals differ by at most what the solutions' difference
    # explains
    d = A.to_scipy() @ (np.asarray(rt.solution, np.float64) - rj.solution)
    assert abs(rt.relative_residual_norm - rj.relative_residual_norm) <= (
        np.linalg.norm(d) / np.linalg.norm(b) * (1 + 1e-9) + 1e-15)
    np.testing.assert_allclose(rt.residual_norm / rt.relative_residual_norm,
                               np.linalg.norm(b), rtol=1e-12)
    for f in ("local_resnorm_history", "global_resnorm_history",
              "inner_iters_history", "comm_matrix"):
        a, c = getattr(rj, f), getattr(rt, f)
        assert a.shape == c.shape and np.array_equal(a, c), f


def _lap(n=16):
    A = tmodels.laplacian_2d(n)
    return A, tmodels.generate_rhs(A.n, random=False)


def _rel_err(A, b, x):
    x_ref = spla.spsolve(A.to_scipy().tocsc(), b)
    return np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)


@pytest.mark.parametrize("px,py,D", [(2, 2, 4), (2, 2, 1), (4, 2, 8),
                                     (4, 2, 2), (4, 4, 4)])
def test_converges_to_direct_solution(px, py, D):
    A, b = _lap(32)
    s = AsyncRASolver2D(A, b, px, py, tolerance=1e-5, ninner=20,
                        chunk_rounds=8, num_ranks=D, device="cpu")
    x, info = s.run(max_rounds=400)
    assert info["converged"] and len(info["done_at"]) == D
    assert info["relative_residual_norm"] < 1e-4
    assert _rel_err(A, b, x) < 1e-3


def test_padding_blocks_run_and_gossip():
    """n = 16 with px = 2: the second block column owns only padding
    (identity rows), and still runs, sends and gossips."""
    A, b = _lap()
    s = AsyncRASolver2D(A, b, 2, 2, tolerance=1e-4, ninner=12,
                        chunk_rounds=8, device="cpu")
    assert s.plan.bx == 128 and s.plan.mask_dom[1].sum() > 0
    assert s.plan.b[1][s.plan.mask_int[1] > 0].sum() == 0
    x, info = s.run(max_rounds=200)
    assert info["converged"] and (info["done_at"] >= 0).all()
    assert _rel_err(A, b, x) < 1e-3


def test_anisotropic_9_point_converges():
    A = tfem.anisotropic_diffusion_2d(32, eps=5.0, theta=0.4)
    b = np.ones(A.n)
    s = AsyncRASolver2D(A, b, 4, 2, tolerance=1e-4, ninner=20,
                        chunk_rounds=10, device="cpu")
    assert s.plan.coef[:, 5:].any()
    x, info = s.run(max_rounds=600)
    assert info["converged"] and _rel_err(A, b, x) < 1e-2


def test_oras_converges_not_slower():
    A, b = _lap(32)

    def run(c):
        s = AsyncRASolver2D(A, b, px=2, py=4, tolerance=1e-4, ninner=12,
                            chunk_rounds=8, oras_weight=c, device="cpu")
        x, info = s.run(max_rounds=400)
        assert info["converged"] and _rel_err(A, b, x) < 1e-2
        return info["rounds"]

    assert run(-0.8) <= run(0.0)


def test_run_refined_reaches_1e8():
    A, b = _lap()
    s = AsyncRASolver2D(A, b, 2, 2, tolerance=1e-4, ninner=20,
                        chunk_rounds=16, device="cpu")
    x, info = s.run_refined(tol=1e-8, max_rounds=400)
    assert info["converged"] and info["relative_residual_norm"] <= 1e-8
    assert info["restarts"] >= 2
    r = b - A.to_scipy() @ x
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-8
    # the solver's own rhs and its windows are restored after the restarts
    np.testing.assert_array_equal(s.rhs, b)
    fresh = AsyncRASolver2D(A, b, 2, 2, device="cpu")
    np.testing.assert_array_equal(s.plan.b, fresh.plan.b)
    assert (s._dev["b"] == fresh._dev["b"]).all()


def test_checkpoint_resume_matches_straight_run(tmp_path):
    A, b = _lap(32)
    kw = dict(px=2, py=2, tolerance=1e-4, ninner=12, chunk_rounds=8,
              device="cpu")
    sol_ref, info_ref = AsyncRASolver2D(A, b, **kw).run(max_rounds=200)
    assert info_ref["converged"] and info_ref["rounds"] > 16
    ck = str(tmp_path / "fr2d")
    s1 = AsyncRASolver2D(A, b, **kw)
    _, info_cap = s1.run(max_rounds=16, checkpoint_path=ck)
    assert not info_cap["converged"]
    with np.load(ck + ".npz") as f:            # the JAX package's format
        assert [f[k].shape for k in sorted(f.files)] == [
            (4, s1.plan.By, s1.plan.Bx), (4, 128), (4, 128)]
    s2 = AsyncRASolver2D(A, b, **kw)
    sol2, info2 = s2.run(max_rounds=200, resume_state=s2.load_checkpoint(ck))
    # the lockstep schedule is deterministic: resumed == straight run
    np.testing.assert_array_equal(sol_ref, sol2)
    np.testing.assert_array_equal(info_ref["done_at"], info2["done_at"])


def test_fresh_read_converges_with_hits():
    """At staleness 3 the lockstep emulation reads message t-1 in all four
    directions; the fixed point is unchanged."""
    A, b = _lap(32)
    s = AsyncRASolver2D(A, b, 2, 2, tolerance=1e-5, staleness=3, ninner=20,
                        chunk_rounds=10, fresh_read=True, device="cpu")
    x, info = s.run(max_rounds=400)
    assert info["converged"] and info["fresh_read_hits"] > 0
    # four directions, B - 1 = 2 newer slots, every round from t = B on
    launches = info["rounds"] // 10
    assert info["fresh_read_hits"] == 4 * 8 * (10 - 3) * launches
    assert _rel_err(A, b, x) < 1e-3
    stale = AsyncRASolver2D(A, b, 2, 2, tolerance=1e-5, staleness=3,
                            ninner=20, chunk_rounds=10, device="cpu")
    assert stale.run(max_rounds=400)[1]["fresh_read_hits"] == 0


def test_overlap_beyond_the_halo_tile():
    """Overlap 8 raises in the solver and routes to the 1-D tier in the
    dispatch, which honours any overlap."""
    A, b = _lap(64)
    with pytest.raises(NotImplementedFeature, match="arbitrary overlap"):
        AsyncRASolver2D(A, b, 2, 2, overlap=8, device="cpu")
    solver, _ = tras.make_free_running_solver(
        A, b, 4, tcfg.Settings(free_running=True, overlap=8, tolerance=1e-3),
        device="cpu")
    assert isinstance(solver, AsyncRASolver) and solver.plan.ovp >= 8 * 64
