"""The port's instrumented run (``RASolver.run_instrumented``: the loop of
``run()`` with each stage timed, the device synchronized) and
``run_accelerated(instrument=True)`` against the JAX package's, on the CPU.

The four cases of ``tests/test_instrumented.py``, through both packages.
float64: equal iteration counts, global histories within rtol 1e-8 plus an
atol of 1e-12 of the largest entry at outer tolerance 1e-6; the port's
instrumented solution equal to its own ``run()`` within rtol 1e-10, atol
1e-12 (the JAX test's bar); the same set of stage names.  Inner
iteration counts within 3: a CG at local tolerance 1e-12 hovers at its
threshold.  The mixed-precision case (float32 locals capped at 10
iterations after the third, outer tolerance 1e-8) holds the histories at
4e-3, about twice the packages' gap on it: the float32 inner counts part
by up to 2 in the first iterations and the capped solves amplify that to
1.6e-3 relative from the seventh entry on, in ``run()`` as in
``run_instrumented()`` (each package's two loops agree bit for bit).
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
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import RASolver as TSolver
from schwarz_tpu_torch.utils import STAGES
from test_torch_local_solvers import settings

TWO_LEVEL_STAGES = set(STAGES) | {"coarse_correction", "residual_recompute"}

CASES = {
    # (n, S, ranks, random rhs, settings, history rtol, stage names)
    "oras0": (20, 4, None, True, dict(overlap=3, tolerance=1e-6,
                                      max_iters=200, oras_weight=0.0),
              1e-8, set(STAGES)),
    "oras-0.5": (20, 4, None, True, dict(overlap=3, tolerance=1e-6,
                                         max_iters=200, oras_weight=-0.5),
                 1e-8, set(STAGES)),
    "neighbor_two_level": (24, 4, 4, True, dict(
        overlap=3, tolerance=1e-6, max_iters=150, two_level=True,
        strategy="neighbor"), 1e-8, TWO_LEVEL_STAGES),
    "mixed_precision": (16, 4, None, False, dict(
        overlap=3, tolerance=1e-8, max_iters=300, dtype="float64",
        local_compute_dtype="float32", local_max_iters=10,
        reset_local_crit_iter=3), 4e-3, set(STAGES)),
}


def _pair(name):
    n, S, ranks, random, kw, _, _ = CASES[name]
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n, random=random)
    mesh = None if ranks is None else make_mesh(jax.devices()[:ranks])
    js = JSolver(jdecompose(A, b, settings(jcfg, **kw), S), mesh=mesh)
    ts = TSolver(tdecompose(A, b, settings(tcfg, **kw), S), device="cpu",
                 num_ranks=ranks)
    return js, ts


@pytest.fixture(scope="module", params=list(CASES))
def instrumented(request):
    js, ts = _pair(request.param)
    return (request.param, js.run_instrumented(), ts.run_instrumented(),
            ts.run())


def test_instrumented_matches_jax(instrumented):
    name, rj, rt, _ = instrumented
    rtol = CASES[name][5]
    assert rj.converged and rt.converged, name
    assert rt.iters == rj.iters, (rt.iters, rj.iters)
    hj = rj.global_resnorm_history
    assert rt.global_resnorm_history.shape == hj.shape
    np.testing.assert_allclose(rt.global_resnorm_history, hj, rtol=rtol,
                               atol=1e-12 * np.abs(hj).max())
    gap = np.abs(rt.inner_iters_history.astype(np.int64)
                 - rj.inner_iters_history).max()
    assert gap <= 3, gap


def test_instrumented_matches_own_run(instrumented):
    _, _, rt, rf = instrumented
    assert rf.converged and rt.iters == rf.iters
    np.testing.assert_allclose(rt.solution, rf.solution, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(rt.global_resnorm_history,
                                  rf.global_resnorm_history)
    assert rf.stage_timings is None


def test_instrumented_stage_names_match_jax(instrumented):
    name, rj, rt, _ = instrumented
    assert set(rt.stage_timings) == set(rj.stage_timings) == CASES[name][6]
    for st, v in rt.stage_timings.items():
        assert set(v) == set(rj.stage_timings[st]), st
        assert v["total"] > 0 and v["min"] <= v["med"] <= v["max"]
    # each one-level stage runs once per solving iteration; the exchange
    # and the check once more on the exit pass
    assert rt.stage_timings["local_solve"]["count"] == rt.iters
    n_exchange = rt.iters + 1 + (rt.iters if "two_level" in name else 0)
    assert rt.stage_timings["boundary_exchange"]["count"] == n_exchange


def test_instrumented_raises_on_stale_modes():
    A = tmodels.laplacian_2d(12)
    b = tmodels.generate_rhs(A.n)
    for comm in (tcfg.CommSettings(overlap_comm=True),
                 tcfg.CommSettings(onesided=True, staleness=2)):
        s = tcfg.Settings(overlap=2, comm=comm)
        solver = TSolver(tdecompose(A, b, s, 2), device="cpu")
        with pytest.raises(ValueError, match="fresh halos"):
            solver.run_instrumented()


def test_accelerated_instrument_matches_jax():
    kw = dict(overlap=3, tolerance=1e-6, max_iters=100, restart_iter=20,
              accelerator="fgmres")
    A = tmodels.laplacian_2d(16)
    b = tmodels.generate_rhs(A.n)
    rj = JSolver(jdecompose(A, b, settings(jcfg, **kw), 4)).run_accelerated(
        instrument=True)
    rt = TSolver(tdecompose(A, b, settings(tcfg, **kw), 4),
                 device="cpu").run_accelerated(instrument=True)
    assert rt.converged and rt.iters == rj.iters
    assert set(rt.stage_timings) == set(rj.stage_timings) == {
        "accel_matvec", "accel_precond"}
    for st, v in rt.stage_timings.items():
        assert set(v) == set(rj.stage_timings[st]), st
        assert 0 < v["min"] <= v["med"] <= v["max"] <= v["total"]
