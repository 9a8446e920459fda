"""The port's Krylov-accelerated solve (``RASolver.run_accelerated``: FGMRES
preconditioned by one RAS application, ``solvers/global_krylov.py``)
against the JAX package's, on the CPU.

float64: equal FGMRES iteration counts, solutions within 1e-10 relative,
histories within rtol 1e-8 plus an atol of 1e-12 of the largest entry.
float32 locals under a float64 outer loop: equal counts, histories within
about twice the gap read on the configuration.  The JAX FGMRES
configurations compile for a few seconds each on the CPU, so they are few,
small, and shared through module-scoped fixtures.
"""

import jax
import numpy as np
import pytest

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.parallel.mesh import make_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch import NotImplementedFeature
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import RASolver as TSolver
from schwarz_tpu_torch.ras import solve as tsolve
from test_torch_local_solvers import settings

CONFIGS = {
    # CG locals, 1-D strips, restarted every 5 iterations
    "cg": (24, 4, None, dict(overlap=3, restart_iter=5)),
    # overlap 1: interior rows carry interface couplings, which the
    # operator must keep
    "overlap1": (24, 4, None, dict(overlap=1, restart_iter=40)),
    # dense Cholesky locals through the explicit inverse on a 2-D
    # partition: the reduced form of the card's direct-locals phase
    "cholesky_inverse": (32, 16, None, dict(
        partition="regular2d", overlap=4, local_solver="cholesky",
        direct_apply="inverse", restart_iter=30, row_pad_multiple=16)),
    # the neighbour exchange, 8 subdomains on 4 ranks, and the two-level
    # coarse correction inside the preconditioner
    "neighbor_two_level": (24, 8, 4, dict(
        overlap=3, restart_iter=20, strategy="neighbor", two_level=True,
        coarse_aggregates=2, precond="block_jacobi",
        block_jacobi_block_size=8)),
}


def _pair(name, **extra):
    n, S, ranks, kw = CONFIGS[name]
    kw = {**kw, "tolerance": 1e-6, "max_iters": 300, **extra}
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n)
    mesh = None if ranks is None else make_mesh(jax.devices()[:ranks])
    js = JSolver(jdecompose(A, b, settings(jcfg, **kw), S), mesh=mesh)
    ts = TSolver(tdecompose(A, b, settings(tcfg, **kw), S), device="cpu",
                 num_ranks=ranks)
    return js, ts


@pytest.fixture(scope="module", params=list(CONFIGS))
def accelerated(request):
    js, ts = _pair(request.param)
    return request.param, ts, js.run_accelerated(), ts.run_accelerated()


def test_fgmres_matches_jax(accelerated):
    name, _, rj, rt = accelerated
    assert rj.converged and rt.converged, name
    assert rt.iters == rj.iters
    hj = rj.global_resnorm_history
    assert len(hj) == rt.iters + 1
    np.testing.assert_allclose(rt.global_resnorm_history, hj, rtol=1e-8,
                               atol=1e-12 * np.abs(hj).max())
    x = rj.solution
    assert np.linalg.norm(rt.solution - x) <= 1e-10 * np.linalg.norm(x)
    assert rt.relative_residual_norm <= 1e-6


def test_fgmres_chunked_equals_unchunked(accelerated):
    """``chunk_iters`` rounds up to restart cycles; each chunk resumes the
    cycle state, so the result is the unchunked run's bit for bit."""
    _, ts, _, rt = accelerated
    rc = ts.run_accelerated(chunk_iters=ts.settings.restart_iter + 1)
    assert rc.iters == rt.iters
    np.testing.assert_array_equal(rc.global_resnorm_history,
                                  rt.global_resnorm_history)
    np.testing.assert_array_equal(rc.solution, rt.solution)


def test_solve_dispatches_fgmres():
    """``solve(accelerator='fgmres')`` runs ``run_accelerated``, as the
    JAX package's ``solve`` does."""
    n, S, _, kw = CONFIGS["cg"]
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n)
    s = settings(tcfg, tolerance=1e-6, max_iters=300, **kw)
    direct = TSolver(tdecompose(A, b, s, S), device="cpu").run_accelerated()
    via = tsolve(A, b, s.replace(accelerator="fgmres"), S, device="cpu")
    assert via.iters == direct.iters < 40
    np.testing.assert_array_equal(via.global_resnorm_history,
                                  direct.global_resnorm_history)


# float32 Cholesky locals (explicit inverse) under a float64 outer loop,
# 32^2 on 4 strips: FGMRES converges in 19 iterations in both packages;
# the histories read a gap of 3.0e-5 (the float32 factor's rounding)
F32_FGMRES_RTOL = 6e-5


def test_fgmres_f32_direct_locals_match_jax():
    kw = dict(overlap=2, local_solver="cholesky", direct_apply="inverse",
              local_compute_dtype="float32", tolerance=1e-8, max_iters=200,
              restart_iter=30)
    A = tmodels.laplacian_2d(32)
    b = tmodels.generate_rhs(A.n)
    rj = JSolver(jdecompose(A, b, settings(jcfg, **kw), 4)).run_accelerated()
    rt = TSolver(tdecompose(A, b, settings(tcfg, **kw), 4),
                 device="cpu").run_accelerated()
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    hj = rj.global_resnorm_history
    np.testing.assert_allclose(rt.global_resnorm_history, hj,
                               rtol=F32_FGMRES_RTOL,
                               atol=1e-8 * np.abs(hj).max())
    assert rt.relative_residual_norm <= 1e-8


def test_fgmres_checkpoint_resumes_in_either_package(tmp_path):
    """A run capped at 5 iterations (one restart cycle) writes its cycle
    state; the state resumes in the other package to the uncapped run's
    count and history (the six-leaf ``.npz`` of
    ``schwarz_tpu/ras.py:2214-2216``)."""
    js, ts = _pair("cg")
    full = ts.run_accelerated()
    jcap, tcap = _pair("cg", max_iters=5)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    rj_cap = jcap.run_accelerated(checkpoint_path=pj)
    rt_cap = tcap.run_accelerated(checkpoint_path=pt)
    assert full.iters > 5
    assert not rj_cap.converged and rj_cap.iters == rt_cap.iters == 5
    with np.load(pj) as a, np.load(pt) as b:
        assert len(a.files) == len(b.files) == 6
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    # JAX's checkpoint in the port, the port's in JAX
    rt = ts.run_accelerated(resume_state=ts.load_accel_checkpoint(pj))
    rj = js.run_accelerated(resume_state=js.load_accel_checkpoint(pt))
    for r in (rt, rj):
        assert r.converged and r.iters == full.iters
        np.testing.assert_allclose(r.global_resnorm_history,
                                   full.global_resnorm_history, rtol=1e-8,
                                   atol=1e-12 * full.global_resnorm_history
                                   .max())
    # the port resumes its own checkpoint bit for bit
    rs = ts.run_accelerated(resume_state=ts.load_accel_checkpoint(pt))
    tcap2 = _pair("cg", max_iters=5)[1].run_accelerated()
    np.testing.assert_array_equal(rs.global_resnorm_history[:6],
                                  tcap2.global_resnorm_history)
    np.testing.assert_array_equal(rs.global_resnorm_history,
                                  full.global_resnorm_history)


def test_instrumented_fgmres_is_not_ported():
    _, ts = _pair("cg")
    with pytest.raises(NotImplementedFeature, match="instruments"):
        ts.run_accelerated(instrument=True)
