"""The port's free-running asynchronous RAS (1-D banded tier, K5) against
the JAX package's, on the CPU.

JAX runs ``AsyncRASolver`` on the 8-device CPU mesh with its Pallas kernel
in interpret mode; the port runs K5's plain PyTorch version, a lockstep
emulation of the free-running ranks.  Without ``fresh_read`` the rounds'
result does not depend on timing, so both must agree up to float32 sums in
another order: x within 1e-4 * max|x|, and ``done_at``, ``rounds`` and
``total_rounds`` equal.  Each JAX configuration compiles for about ten
seconds, so each runs once, for two launches.
"""

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as spla

import schwarz_tpu.config as jcfg
from schwarz_tpu import generate_rhs, laplacian_2d
from schwarz_tpu.models.fem import advection_diffusion_2d, laplacian_3d
from schwarz_tpu.ops.async_ras import AsyncRASolver as JAsync
from schwarz_tpu.parallel.mesh import make_mesh
from schwarz_tpu.ras import solve as jsolve
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
from schwarz_tpu_torch.ras import solve as tsolve

CHUNK = 8
BAR = 1e-4        # x within BAR * max|x|: float32 sums in another order

# name: (operator, solver keywords); tolerances chosen so that every rank
# detects convergence in the second launch or earlier
CASES = {
    "D1-B1": ("lap16", dict(D=1, staleness=1, tolerance=3e-4, ninner=8)),
    "D2-B2": ("lap16", dict(D=2, staleness=2, tolerance=1e-3, ninner=8)),
    "D4-B1": ("lap16", dict(D=4, staleness=1, tolerance=1e-2, ninner=8)),
    "oras": ("lap16", dict(D=4, staleness=1, tolerance=3e-3, ninner=12,
                           oras_weight=-0.8)),
    "bicgstab": ("adv16", dict(D=4, staleness=1, tolerance=1e-3, ninner=8,
                               nonsym=True)),
    "gmres": ("adv16", dict(D=4, staleness=1, tolerance=1e-3, ninner=12,
                            nonsym=True, nonsym_solver="gmres")),
}


def _operator(name):
    A = {"lap16": lambda: laplacian_2d(16),
         "adv16": lambda: advection_diffusion_2d(16)}[name]()
    return A, generate_rhs(A.n, random=False)


def _run_both(name):
    op, kw = CASES[name]
    kw = dict(kw)
    D = kw.pop("D")
    A, b = _operator(op)
    js = JAsync(A, b, num_subdomains=4, overlap=2, chunk_rounds=CHUNK,
                mesh=make_mesh(jax.devices()[:D]), **kw)
    ts = AsyncRASolver(tmodels.CSRMatrix.from_scipy(A.to_scipy()), b, 4,
                       overlap=2, chunk_rounds=CHUNK, num_ranks=D,
                       device="cpu", **kw)
    return js.run(max_rounds=2 * CHUNK), ts.run(max_rounds=2 * CHUNK)


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_jax(name):
    """Measured on the CPU: x within 1.4e-6 (D1-B1) to 2.0e-5 (D4-B1) of
    max|x|, GMRES included, so every case takes the same bar."""
    (xj, ij), (xt, it) = _run_both(name)
    err = float(np.abs(xt - xj).max())
    scale = float(np.abs(xj).max())
    assert err <= BAR * scale, (name, err, scale)
    np.testing.assert_array_equal(it["done_at"], ij["done_at"])
    for k in ("converged", "rounds", "total_rounds", "effective_overlap",
              "fresh_read_hits"):
        assert it[k] == ij[k], k
    assert it["converged"] and it["rounds"] == 2 * CHUNK
    assert len(np.unique(it["done_at"])) > 1 or len(it["done_at"]) == 1
    A, b = _operator(CASES[name][0])
    _residuals_agree(A, b, xt, xj, it["relative_residual_norm"],
                     ij["relative_residual_norm"])
    assert it["comm_bytes_per_device"] > 0


def _residuals_agree(A, b, xt, xj, rel_t, rel_j):
    """The true relative residuals differ by at most what the difference
    of the solutions explains: |r_t - r_j| <= ||A (xt - xj)|| / ||b||.  At a
    detection threshold of 1e-3 this is several per cent of the residual."""
    d = A.to_scipy() @ (np.asarray(xt, np.float64) - xj)
    bound = np.linalg.norm(d) / np.linalg.norm(b)
    assert abs(rel_t - rel_j) <= bound * (1 + 1e-9) + 1e-15, (
        rel_t, rel_j, bound)


def test_solve_free_running_slice_matches_jax():
    """The slice as a whole: solve(free_running=True) on a 3-D Laplacian in
    both packages (the 1-D tier: +-n^2 offsets are no 2-D grid)."""
    A = laplacian_3d(12)
    b = generate_rhs(A.n)
    kw = dict(free_running=True, overlap=2, tolerance=1e-4,
              local_max_iters=16, max_iters=64)
    rj = jsolve(A, b, jcfg.Settings(comm=jcfg.CommSettings(staleness=1),
                                    **kw), num_subdomains=4)
    rt = tsolve(tmodels.laplacian_3d(12), b,
                tcfg.Settings(comm=tcfg.CommSettings(staleness=1), **kw), 4,
                device="cpu")
    assert rt.converged and rj.converged
    assert (rt.iters, rt.diverged) == (rj.iters, rj.diverged)
    err = float(np.abs(rt.solution - rj.solution).max())
    assert err <= BAR * float(np.abs(rj.solution).max()), err
    _residuals_agree(A, b, rt.solution, rj.solution,
                     rt.relative_residual_norm, rj.relative_residual_norm)
    np.testing.assert_allclose(rt.residual_norm / rt.relative_residual_norm,
                               np.linalg.norm(b), rtol=1e-12)
    for f in ("local_resnorm_history", "global_resnorm_history",
              "inner_iters_history", "comm_matrix"):
        a, c = getattr(rj, f), getattr(rt, f)
        assert a.shape == c.shape and np.array_equal(a, c), f


def _lap(n=16):
    A = tmodels.laplacian_2d(n)
    return A, tmodels.generate_rhs(A.n, random=False)


def test_converges_to_direct_solution():
    A, b = _lap()
    s = AsyncRASolver(A, b, 4, overlap=2, tolerance=1e-5, staleness=1,
                      ninner=20, chunk_rounds=8, device="cpu")
    x, info = s.run(max_rounds=200)
    assert info["converged"] and info["relative_residual_norm"] < 1e-4
    x_ref = spla.spsolve(A.to_scipy().tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-3


@pytest.mark.parametrize("D", [1, 2, 4])
def test_folded_ranks_converge(D):
    A, b = _lap()
    s = AsyncRASolver(A, b, 8, overlap=2, tolerance=1e-5, staleness=1,
                      ninner=20, chunk_rounds=8, num_ranks=D, device="cpu")
    assert s.Sl == 8 // D
    x, info = s.run(max_rounds=300)
    assert info["converged"] and len(info["done_at"]) == D
    x_ref = spla.spsolve(A.to_scipy().tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-3


def test_run_refined_reaches_1e8():
    A, b = _lap()
    s = AsyncRASolver(A, b, 4, overlap=2, tolerance=1e-4, staleness=1,
                      ninner=20, chunk_rounds=16, device="cpu")
    x, info = s.run_refined(tol=1e-8, max_rounds=400)
    assert info["converged"] and info["relative_residual_norm"] <= 1e-8
    assert info["restarts"] >= 2
    r = b - A.to_scipy() @ x
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-8
    # the solver's own rhs is restored after the restarts
    np.testing.assert_array_equal(s.rhs, b)


def test_checkpoint_resume(tmp_path):
    A, b = _lap()
    s = AsyncRASolver(A, b, 4, overlap=2, tolerance=1e-5, staleness=1,
                      ninner=20, chunk_rounds=6, device="cpu")
    x_full, info_full = s.run(max_rounds=300)
    ck = str(tmp_path / "async")
    _, info_cap = s.run(max_rounds=6, checkpoint_path=ck)
    assert not info_cap["converged"]
    with np.load(ck + ".npz") as f:            # the JAX package's format
        assert [f[k].shape for k in sorted(f.files)] == [
            (4, s.plan.R), (4, 128), (4, 128), (4, s.plan.hw),
            (4, s.plan.hw)]
    x_res, info_res = s.run(max_rounds=300, resume_state=s.load_checkpoint(ck))
    assert info_res["converged"]
    np.testing.assert_allclose(x_res, x_full, atol=1e-5)
    assert info_res["total_rounds"] == info_full["total_rounds"]
    np.testing.assert_array_equal(info_res["done_at"], info_full["done_at"])


def test_fresh_read_converges_with_hits():
    """At staleness 3 the lockstep emulation reads message t-1, the newest
    one available; the fixed point is unchanged."""
    A, b = _lap()
    s = AsyncRASolver(A, b, 4, overlap=2, tolerance=1e-5, staleness=3,
                      ninner=20, chunk_rounds=10, fresh_read=True,
                      device="cpu")
    x, info = s.run(max_rounds=300)
    assert info["converged"] and info["fresh_read_hits"] > 0
    x_ref = spla.spsolve(A.to_scipy().tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-3


def test_solver_argument_checks():
    A, b = _lap()
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        AsyncRASolver(A, b, 4, num_ranks=3, device="cpu")
    with pytest.raises(ValueError, match="nonsym_solver"):
        AsyncRASolver(A, b, 4, nonsym=True, nonsym_solver="idr",
                      device="cpu")
    # one rank per subdomain by default; the gossip holds 128 lanes
    A2 = tmodels.laplacian_2d(400)
    with pytest.raises(ValueError, match="gossip"):
        AsyncRASolver(A2, np.ones(A2.n), 130, overlap=1, device="cpu")
    assert AsyncRASolver(A2, np.ones(A2.n), 130, overlap=1, num_ranks=65,
                         device="cpu").Sl == 2
    s = AsyncRASolver(A, b, 4, device="cpu")
    # two-level refinement: a host coarse correction before each launch
    x, info = s.run_refined(tol=1e-8, coarse_q=4)
    assert info["converged"] and info["relative_residual_norm"] <= 1e-8


def test_fresh_read_on_card_needs_the_probe():
    from schwarz_tpu_torch.diagnostics import require_flag_order

    with pytest.raises(NotImplementedFeature, match="flag-order probe"):
        require_flag_order("cuda:0")


def test_async_solver_default_device_needs_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = _lap()
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncRASolver(A, b, 4)


def test_diagnostics_plain_versions(capsys):
    from schwarz_tpu_torch import diagnostics

    assert diagnostics.main(["smoke", "flagorder", "--device", "cpu"]) == 0
    assert "DONE" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        diagnostics.main(["spmv", "--device", "cpu"])
