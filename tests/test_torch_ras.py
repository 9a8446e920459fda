"""The port's one-level synchronous RAS solve against the JAX package's, on
the CPU: the same decomposition, the same Settings, the same rhs.  JAX runs
its Pallas kernels in interpret mode; the port runs its kernels' plain
PyTorch versions."""

import numpy as np
import pytest

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.models import generate_rhs, laplacian_2d
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import RASolver as TSolver


def _settings(cfg, **kw):
    """The same Settings in either package (enum fields given by value)."""
    enums = {"precond": cfg.Precond}
    kw = {k: enums[k](v) if k in enums else v for k, v in kw.items()}
    if {"criterion", "method", "check_offset"} & set(kw):
        kw["convergence"] = cfg.ConvergenceSettings(
            criterion=cfg.LocalCriterion(kw.pop("criterion", "solution_based")),
            method=cfg.GlobalConvergence(kw.pop("method", "allgather")),
            enable_global_check_iter_offset=kw.pop("check_offset", False))
    return cfg.Settings(**kw)


def _solvers(n, S, random_rhs=True, **kw):
    A = laplacian_2d(n)
    b = generate_rhs(A.n, random=random_rhs)
    js = JSolver(jdecompose(A, b, _settings(jcfg, **kw), S))
    ts = TSolver(tdecompose(A, b, _settings(tcfg, **kw), S), device="cpu")
    return js, ts


def _check(rj, rt, rtol):
    assert rt.iters == rj.iters
    assert rt.converged == rj.converged and rt.diverged == rj.diverged
    assert len(rt.global_resnorm_history) == len(rj.global_resnorm_history)
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=rtol)
    np.testing.assert_allclose(rt.local_resnorm_history,
                               rj.local_resnorm_history, rtol=rtol,
                               atol=rtol * np.abs(rj.local_resnorm_history).max())
    np.testing.assert_allclose(rt.relative_residual_norm,
                               rj.relative_residual_norm, rtol=max(rtol, 1e-6))


@pytest.mark.parametrize("n,S,overlap,kw", [
    (128, 4, 2, dict(max_iters=20)),
    # the 1M-row slice's settings (chip_smoke.py) on a 256^2 analog
    (256, 16, 3, dict(local_tolerance=1e-6, local_max_iters=50,
                      max_iters=30)),
])
def test_f32_kernel_slice_matches(n, S, overlap, kw):
    """Small forms of the slice: every kernel path on in both packages.
    hist_global within rtol 1e-3 — float32 sums taken in another order."""
    js, ts = _solvers(n, S, random_rhs=False, overlap=overlap,
                      dtype="float32", row_pad_multiple=128,
                      spmv_format="dia", use_pallas="on", halo_fused="on",
                      fused_local_cg=True, precond="jacobi", **kw)
    assert js._use_pallas and js._halo_fused and js._use_fused_cg
    assert ts._local.use_fused_cg
    assert ts._local.dia_offsets == js._dia_offsets
    assert not ts._local.dia_has_remainder
    rj, rt = js.run(), ts.run()
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=1e-3)
    assert np.isfinite(rt.solution).all()


@pytest.mark.parametrize("S,overlap", [(2, 2), (4, 3), (4, 4)])
def test_default_f64_slice_matches(S, overlap):
    """Default Settings (float64, unfused CG): identical iteration counts
    and histories within 1e-8 (the bar of tests/test_reference_parity.py)."""
    js, ts = _solvers(12, S, overlap=overlap)
    rj, rt = js.run(), ts.run()
    assert rj.converged
    _check(rj, rt, 1e-8)
    # inner CG to 1e-12 may stop one iteration apart where the residual
    # ratio lands on the tolerance (sums taken in another order)
    assert np.abs(rt.inner_iters_history - rj.inner_iters_history).max() <= 1
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("kw,rtol", [
    # the DIA operator (K1's plain version) in float64, with Jacobi
    (dict(spmv_format="dia", precond="jacobi"), 1e-8),
    (dict(criterion="residual_based", local_max_iters=30), 1e-8),
    (dict(method="allreduce", tolerance=1e-5), 1e-8),
    # (a budget of 5 makes the warm-started solution-form iteration
    # amplify rounding ~1000x per outer step in either package)
    (dict(local_max_iters=20, reset_local_crit_iter=3), 1e-8),
    (dict(enable_logging=True, max_iters=7), 1e-8),
    # detection held back past 5% of max_iters (solve.cpp:992-996)
    (dict(check_offset=True, max_iters=1000, tolerance=1e-3), 1e-8),
    # float32 local solves under a float64 outer loop (correction form),
    # through the fused CG's plain version: inner float32 rounding
    (dict(local_compute_dtype="float32", spmv_format="dia",
          row_pad_multiple=128, fused_local_cg=True, local_tolerance=1e-6,
          tolerance=1e-8), 1e-4),
])
def test_f64_variants_match(kw, rtol):
    js, ts = _solvers(16, 4, overlap=3, **kw)
    _check(js.run(), ts.run(), rtol)


def test_chunked_run_and_warm_start():
    _, ts = _solvers(12, 4, overlap=2, max_iters=40)
    full = ts.run()
    chunked = ts.run(chunk_iters=3)
    assert chunked.iters == full.iters
    np.testing.assert_array_equal(chunked.global_resnorm_history,
                                  full.global_resnorm_history)
    np.testing.assert_array_equal(chunked.solution, full.solution)
    x0 = np.full((4, ts.meta.max_interior), 0.5)
    js, ts = _solvers(12, 4, overlap=2, max_iters=40)
    _check(js.run(x0=x0), ts.run(x0=x0), 1e-8)
