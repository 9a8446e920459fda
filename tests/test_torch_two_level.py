"""The port's synchronous O-RAS and two-level solves, and its two-level
free-running refinement, against the JAX package's, on the CPU.

The configurations are those of ``tests/test_oras.py`` and
``tests/test_two_level.py``.  With float64 locals the iteration counts are
equal and the histories agree within 1e-8 at an outer tolerance of 1e-6
(at 1e-8 the last entries are rounding noise in either package), or
within 1e-12 of the largest entry: the rounding noise of the local solves
is absolute, and on the smallest late residuals it reaches 2e-8 relative.
With float32 locals under a float64 outer loop the counts are equal and
the histories agree within about twice what sound runs read (or 1e-8 of
the largest entry): the float32 local CG sums in another order than XLA,
a gap of ~1e-6 after the first local solve that a fast-contracting outer
loop lifts on the small late residuals (``tests/torch_f32_readings.py``
reads oras-mixed 6.6e-6, flagship analog 2.2e-5, with DIA 4.7e-5,
oras-fused-cg-mixed 3.6e-6).
A history cannot see where the coarse step casts: with the basis and
inverse applied in float64 the DIA analog reads 8.3e-6, inside its sound
gap.  ``test_torch_coarse.py::test_coarse_correct_casts_like_jax`` holds
that step to the JAX package's bit for bit.  Float32 throughout: 1e-3, or
2e-6 of the largest entry.
"""

import jax
import numpy as np
import pytest

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
import schwarz_tpu.models as jmodels
from schwarz_tpu.ops.async_ras import AsyncRASolver as JAsync
from schwarz_tpu.ops.async_ras_2d import AsyncRASolver2D as J2D
from schwarz_tpu.ops.async_ras_general import AsyncGeneralRASolver as JGen
from schwarz_tpu.parallel.mesh import make_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.core.partition import partition_metis
from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
from schwarz_tpu_torch.ras import RASolver as TSolver


def _settings(cfg, **kw):
    enums = {"precond": cfg.Precond, "partition": cfg.Partition}
    if "criterion" in kw:
        kw["convergence"] = cfg.ConvergenceSettings(
            criterion=cfg.LocalCriterion(kw.pop("criterion")))
    return cfg.Settings(**{k: enums[k](v) if k in enums else v
                           for k, v in kw.items()})


def _solvers(n, S, **kw):
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n)
    js = JSolver(jdecompose(A, b, _settings(jcfg, **kw), S))
    ts = TSolver(tdecompose(A, b, _settings(tcfg, **kw), S), device="cpu")
    return js, ts


def _check(rj, rt, rtol, floor):
    """Equal counts; histories within ``rtol``, or within ``floor`` times
    the largest entry (the absolute rounding noise of the inner solves)."""
    assert rj.converged and rt.iters == rj.iters
    hj = rj.global_resnorm_history
    assert len(rt.global_resnorm_history) == len(hj)
    np.testing.assert_allclose(rt.global_resnorm_history, hj, rtol=rtol,
                               atol=floor * np.abs(hj).max())
    np.testing.assert_allclose(
        rt.local_resnorm_history, rj.local_resnorm_history, rtol=rtol,
        atol=rtol * np.abs(rj.local_resnorm_history).max())
    # the true residual of the final iterate carries that iterate's own
    # rounding (float32 throughout: ~1e-6 of ||b||)
    np.testing.assert_allclose(rt.relative_residual_norm,
                               rj.relative_residual_norm, rtol=max(rtol, 1e-6),
                               atol=10 * floor)


# (n, S, settings): float64 locals, outer tolerance 1e-6
F64_CASES = {
    "oras": (24, 4, dict(overlap=2, oras_weight=-0.8)),
    "oras-dia": (24, 4, dict(overlap=2, oras_weight=-0.8, spmv_format="dia")),
    "oras-overlap3": (24, 4, dict(overlap=3, oras_weight=-0.7)),
    "oras-auto": (32, 8, dict(overlap=2, oras_weight="auto")),
    "oras-jacobi": (24, 4, dict(overlap=2, oras_weight=-0.8,
                                precond="jacobi")),
    "oras-residual": (24, 4, dict(overlap=2, oras_weight=-0.8,
                                  criterion="residual_based")),
    "oras-fsai": (24, 4, dict(overlap=2, oras_weight=-0.8, precond="fsai",
                              spmv_format="dia")),
    "oras-two-level": (24, 4, dict(overlap=2, oras_weight=-0.8,
                                   two_level=True)),
    "oras-auto-two-level": (24, 4, dict(overlap=2, oras_weight="auto",
                                        two_level=True)),
    "two-level": (24, 8, dict(overlap=3, two_level=True)),
    "two-level-q4": (24, 4, dict(overlap=3, two_level=True,
                                 coarse_aggregates=4, row_pad_multiple=64)),
    "two-level-dia": (24, 8, dict(overlap=3, two_level=True,
                                  spmv_format="dia")),
    "spectral-q4": (24, 4, dict(overlap=3, two_level=True,
                                coarse_space="spectral",
                                coarse_aggregates=4)),
    "aggregates-cg": (32, 8, dict(overlap=3, two_level=True,
                                  coarse_aggregates=2, coarse_solver="cg")),
    "spectral-cg": (32, 8, dict(overlap=3, two_level=True,
                                coarse_aggregates=2, coarse_space="spectral",
                                coarse_solver="cg")),
    "two-level-block-jacobi": (32, 4, dict(
        overlap=4, two_level=True, partition="regular2d",
        precond="block_jacobi", local_max_iters=20, row_pad_multiple=128,
        coarse_aggregates=8, coarse_space="spectral")),
    "two-level-residual": (24, 4, dict(overlap=3, two_level=True,
                                       criterion="residual_based",
                                       coarse_aggregates=2)),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_f64_solve_matches(case):
    n, S, kw = F64_CASES[case]
    js, ts = _solvers(n, S, tolerance=1e-6, max_iters=400, **kw)
    assert ts._oras_c == js._oras_c
    _check(js.run(), ts.run(), 1e-8, 1e-12)


# float32 locals under the float64 outer loop, and float32 throughout
F32_CASES = {
    "oras-mixed": (24, 4, dict(overlap=2, oras_weight=-0.8, tolerance=1e-8,
                               local_compute_dtype="float32"), 2e-5, 1e-8),
    # the flagship recipe (bench.py:531-539) at 64^2, S = 4, q = 8
    "flagship-analog": (64, 4, dict(
        overlap=6, tolerance=1e-8, max_iters=200, dtype="float64",
        local_compute_dtype="float32", local_tolerance=1e-6,
        local_max_iters=20, precond="fsai", row_pad_multiple=128,
        two_level=True, coarse_aggregates=8, coarse_space="spectral"),
        5e-5, 1e-8),
    "flagship-analog-dia": (64, 4, dict(
        overlap=6, tolerance=1e-8, max_iters=200, dtype="float64",
        local_compute_dtype="float32", local_tolerance=1e-6,
        local_max_iters=20, precond="fsai", row_pad_multiple=128,
        two_level=True, coarse_aggregates=8, coarse_space="spectral",
        spmv_format="dia"), 1e-4, 1e-8),
    # K3's plain version on the Robin-modified operator (float32
    # throughout)
    "oras-fused-cg": (24, 4, dict(
        overlap=2, tolerance=2e-5, max_iters=300, dtype="float32",
        fused_local_cg=True, precond="jacobi", row_pad_multiple=128,
        spmv_format="dia", oras_weight=-0.8), 1e-3, 2e-6),
    "oras-fused-cg-mixed": (32, 4, dict(
        overlap=2, tolerance=1e-8, max_iters=300, oras_weight="auto",
        local_compute_dtype="float32", fused_local_cg=True,
        precond="jacobi", row_pad_multiple=128, spmv_format="dia",
        local_tolerance=1e-6), 1e-5, 1e-8),
}


@pytest.mark.parametrize("case", list(F32_CASES))
def test_f32_locals_solve_matches(case, monkeypatch):
    monkeypatch.delenv("SCHWARZ_TPU_COARSE_CACHE", raising=False)
    n, S, kw, rtol, floor = F32_CASES[case]
    js, ts = _solvers(n, S, **kw)
    if kw.get("fused_local_cg"):
        assert js._use_fused_cg and ts._local.use_fused_cg
    if kw.get("spmv_format") == "dia" and kw.get("precond") == "fsai":
        assert ts._local.fsai_offsets == js._fsai_offsets
    rj, rt = js.run(), ts.run()
    _check(rj, rt, rtol, floor)
    if kw.get("tolerance") == 1e-8:
        assert rt.relative_residual_norm <= 1e-8


@pytest.mark.parametrize("weight,two_level,want", [
    ("auto", False, -0.8), ("auto", True, -0.6), (-0.3, False, -0.3),
    (0.0, True, 0.0)])
def test_oras_weight_resolution(weight, two_level, want):
    js, ts = _solvers(16, 4, oras_weight=weight, two_level=two_level)
    assert ts._oras_c == js._oras_c == want
    assert ts._local.oras == js._oras == (want != 0)
    assert ("oras_diag" in ts._plan) == ("oras_diag" in js._plan)


@pytest.mark.parametrize("weight,match", [
    (-1.5, r"outside \[-1, 0\]"), (0.2, r"outside \[-1, 0\]"),
    ("fast", "must be a float or 'auto'")])
def test_oras_weight_refused_like_jax(weight, match):
    with pytest.raises(ValueError, match=match):
        _solvers(16, 4, oras_weight=weight)


def test_oras_plan_bit_for_bit():
    """The boost, the Robin-modified DIA and ELL solve copies: the first
    col == row match of each row only."""
    js, ts = _solvers(24, 4, overlap=2, oras_weight=-0.8,
                      local_compute_dtype="float32", spmv_format="dia")
    for k in ("oras_diag", "dia_vals_solve", "dia_vals_solve_lc"):
        np.testing.assert_array_equal(ts._plan[k].numpy(),
                                      np.asarray(js._plan[k]), err_msg=k)
    js2, ts2 = _solvers(24, 4, overlap=2, oras_weight=-0.8)
    for k in ("oras_diag", "lmat_vals_solve"):
        np.testing.assert_array_equal(ts2._plan[k].numpy(),
                                      np.asarray(js2._plan[k]), err_msg=k)


def _refine_pair(tier):
    """The JAX package's free-running solver of a tier and the port's, on
    the same problem and settings, and the target of the refinement."""
    n = {"1d": 32, "2d": 16, "general": 12}[tier]
    A, jA = tmodels.laplacian_2d(n), jmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n, random=False)
    mesh = make_mesh(jax.devices()[:4])
    if tier == "1d":
        kw = dict(num_subdomains=4, overlap=2, tolerance=1e-2, staleness=1,
                  ninner=16, chunk_rounds=8)
        return (JAsync(A, b, mesh=mesh, **kw),
                AsyncRASolver(A, b, num_ranks=4, device="cpu", **kw), 1e-9)
    if tier == "2d":
        kw = dict(px=2, py=2, tolerance=1e-3, ninner=8, chunk_rounds=4)
        return (J2D(jA, b, mesh=mesh, **kw),
                AsyncRASolver2D(A, b, num_ranks=4, device="cpu", **kw), 1e-8)
    kw = dict(overlap=2, tolerance=1e-2, ninner=8, chunk_rounds=4,
              part=partition_metis(A, 4))
    return (JGen(jA, b, 4, **kw),
            AsyncGeneralRASolver(A, b, 4, device="cpu", **kw), 1e-9)


@pytest.mark.parametrize("tier", ["1d", "2d", "general"])
def test_run_refined_two_level_matches_jax(tier):
    """Two-level free-running refinement (``coarse_q=4``) on each tier: the
    same restarts with the same rounds and ``done_at`` in each, both at the
    target, the true residuals within float32 rounding of each other (the
    kernel's rounds, lifted by the restarts).  The coarse strips default to
    the plan's subdomain count in both packages."""
    js, ts, tol = _refine_pair(tier)
    xj, ij = js.run_refined(tol=tol, max_rounds=400, coarse_q=4)
    xt, it = ts.run_refined(tol=tol, max_rounds=400, coarse_q=4)
    assert ij["converged"] and it["converged"]
    assert it["restarts"] == ij["restarts"] >= 1
    for a, c in zip(ij["inner_infos"], it["inner_infos"]):
        assert c["rounds"] == a["rounds"]
        np.testing.assert_array_equal(c["done_at"], a["done_at"])
    assert it["relative_residual_norm"] <= tol
    np.testing.assert_allclose(it["relative_residual_norm"],
                               ij["relative_residual_norm"], rtol=0.2)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8 * np.abs(xj).max())


def test_run_refined_two_level_stalled_restart_matches_jax():
    """Two-level refinement whose restarts do not halve the residual: one
    round a restart on the 1-D tier.  With the coarse step the plateau
    test does not stop the loop in the JAX package
    (``schwarz_tpu/ops/async_ras.py:1093``); the restart budget does.  The
    port stopped after the first restart (at 1.53 where the JAX package
    reaches 8.3e-6 in 12)."""
    A = tmodels.laplacian_2d(32)
    b = tmodels.generate_rhs(A.n, random=False)
    kw = dict(num_subdomains=4, overlap=2, tolerance=1e-2, staleness=1,
              ninner=16, chunk_rounds=1)
    js = JAsync(A, b, mesh=make_mesh(jax.devices()[:4]), **kw)
    ts = AsyncRASolver(A, b, num_ranks=4, device="cpu", **kw)
    _, ij = js.run_refined(tol=1e-9, max_rounds=1, coarse_q=4,
                           max_restarts=12)
    _, it = ts.run_refined(tol=1e-9, max_rounds=1, coarse_q=4,
                           max_restarts=12)
    assert it["restarts"] == ij["restarts"] == 12
    np.testing.assert_allclose(it["relative_residual_norm"],
                               ij["relative_residual_norm"], rtol=0.2)


@pytest.mark.parametrize("strategy,comm", [
    ("neighbor", {}),
    ("rdma", dict(enable_put=True, enable_get=False)),
    ("rdma", dict(enable_one_by_one=True, flush_type="flush-local")),
])
def test_two_level_on_rank_strategies_matches(strategy, comm):
    """The second exchange of a two-level iteration on the neighbour and
    one-sided strategies (K4's plain version here), 8 subdomains on 4
    ranks, against the JAX package on a mesh of 4 devices."""
    A = tmodels.laplacian_2d(24)
    b = tmodels.generate_rhs(A.n)

    def st(cfg):
        return cfg.Settings(
            overlap=3, tolerance=1e-6, max_iters=400, two_level=True,
            oras_weight="auto", coarse_aggregates=2,
            comm=cfg.CommSettings(strategy=cfg.HaloStrategy(strategy),
                                  **comm))

    rj = JSolver(jdecompose(A, b, st(jcfg), 8),
                 mesh=make_mesh(jax.devices()[:4])).run()
    rt = TSolver(tdecompose(A, b, st(tcfg), 8), device="cpu",
                 num_ranks=4).run()
    _check(rj, rt, 1e-8, 1e-12)
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=1e-8,
                               atol=1e-12)
