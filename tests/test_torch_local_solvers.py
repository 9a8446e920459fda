"""The port's GMRES and dense direct local solvers, ``inner_operator=
'dia_only'`` and ``comm.overlap_split`` against the JAX package's, on the
CPU.

Factors and applies: torch.linalg against jax.numpy on the same local
matrices, within 1e-12 relative (normwise) in float64 and 1e-5 in float32.
``gmres_solve``: equal iteration counts, solutions within 1e-10 relative.
Solves: equal outer iteration counts, global histories within rtol 1e-8
plus an atol of 1e-12 of the largest entry, at an outer tolerance of 1e-6
(at 1e-8 the last entries are rounding noise in either package).  The JAX
GMRES configurations compile slowly on the CPU, so they are few and small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarz_tpu.config as jcfg
import schwarz_tpu.solvers.direct as jdirect
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.ras import RASolver as JSolver
from schwarz_tpu.solvers.gmres import gmres_solve as jgmres
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.solvers.direct as tdirect
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import RASolver as TSolver
from schwarz_tpu_torch.solvers.gmres import gmres_solve as tgmres
from schwarz_tpu_torch.solvers.precond import jacobi_inverse
from schwarz_tpu_torch.utils import timing


def settings(cfg, **kw):
    """Settings of either package from plain values (enum values as
    strings, ``criterion`` and ``overlap_split`` lifted into their
    sub-settings)."""
    enums = {"precond": cfg.Precond, "partition": cfg.Partition,
             "local_solver": cfg.LocalSolver}
    kw = {k: enums[k](v) if k in enums else v for k, v in kw.items()}
    if "criterion" in kw:
        kw["convergence"] = cfg.ConvergenceSettings(
            criterion=cfg.LocalCriterion(kw.pop("criterion")))
    comm = {k: kw.pop(k) for k in ("overlap_split", "strategy")
            if k in kw}
    if "strategy" in comm:
        comm["strategy"] = cfg.HaloStrategy(comm["strategy"])
    if comm:
        kw["comm"] = cfg.CommSettings(**comm)
    return cfg.Settings(**kw)


def both(n, S, problem="laplacian_2d", **kw):
    """The JAX package's solver and the port's on the same problem."""
    A = getattr(tmodels, problem)(n)
    b = tmodels.generate_rhs(A.n)
    return (JSolver(jdecompose(A, b, settings(jcfg, **kw), S)),
            TSolver(tdecompose(A, b, settings(tcfg, **kw), S), device="cpu"))


def check_histories(rj, rt, rtol=1e-8, floor=1e-12, inner=True):
    """Equal outer counts, histories within ``rtol`` or ``floor`` of the
    largest entry, and (``inner``) equal inner counts.  A warm-started
    inner solve whose relative residual lands at its threshold may stop an
    iteration apart in the two packages (sums in another order), so the
    cases that hover there compare the outer history alone."""
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    hj = rj.global_resnorm_history
    assert len(rt.global_resnorm_history) == len(hj)
    np.testing.assert_allclose(rt.global_resnorm_history, hj, rtol=rtol,
                               atol=floor * np.abs(hj).max())
    if inner:
        np.testing.assert_array_equal(rt.inner_iters_history,
                                      rj.inner_iters_history)
    np.testing.assert_allclose(rt.relative_residual_norm,
                               rj.relative_residual_norm,
                               rtol=max(rtol, 1e-6))


def _normwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module", params=["float64", "float32"])
def local_spd(request):
    """The local matrices of a 12^2 Laplacian on 4 strips, overlap 3, and
    a seeded batch of right-hand sides, in one dtype."""
    A = tmodels.laplacian_2d(12)
    dec = tdecompose(A, tmodels.generate_rhs(A.n),
                     tcfg.Settings(overlap=3), 4)
    dt = request.param
    rng = np.random.default_rng(3)
    b = rng.standard_normal(dec.local_rhs.shape).astype(dt)
    return dt, dec.lmat_vals.astype(dt), dec.lmat_cols, b


def test_cholesky_factor_and_applies_match_jax(local_spd):
    dt, vals, cols, b = local_spd
    tol = TOL[dt]
    Lj = jdirect.cholesky_factor(jnp.asarray(vals), jnp.asarray(cols))
    Lt = tdirect.cholesky_factor(torch.from_numpy(vals),
                                 torch.from_numpy(cols))
    assert _normwise(Lt, Lj) <= tol
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    assert _normwise(tdirect.cholesky_solve(Lt, bt),
                     jdirect.cholesky_solve(Lj, bj)) <= tol
    Aj, At = jdirect.cholesky_inverse(Lj), tdirect.cholesky_inverse(Lt)
    assert _normwise(At, Aj) <= tol
    assert _normwise(tdirect.inverse_apply(At, bt),
                     jdirect.inverse_apply(Aj, bj)) <= tol


@pytest.mark.parametrize("block", [8, 22, 88])
def test_blocked_substitution_matches_jax(local_spd, block):
    """The blocked apply against the JAX package's at several block sizes
    (88 = R: one block), and against the plain substitution."""
    dt, vals, cols, b = local_spd
    tol = TOL[dt]
    Lj = jdirect.cholesky_factor(jnp.asarray(vals), jnp.asarray(cols))
    Lt = tdirect.cholesky_factor(torch.from_numpy(vals),
                                 torch.from_numpy(cols))
    assert Lt.shape[-1] == 88
    Dj = jdirect.block_diag_inverses(Lj, block)
    Dt = tdirect.block_diag_inverses(Lt, block)
    assert _normwise(Dt, Dj) <= tol
    bt = torch.from_numpy(b)
    xt = tdirect.blocked_cholesky_solve(Lt, Dt, bt)
    assert _normwise(xt, jdirect.blocked_cholesky_solve(
        Lj, Dj, jnp.asarray(b))) <= tol
    assert _normwise(xt, tdirect.cholesky_solve(Lt, bt)) <= tol
    with pytest.raises(ValueError):
        tdirect.block_diag_inverses(Lt, 7)


@pytest.mark.parametrize("R", [1024, 640, 96, 48, 13])
def test_pick_trisolve_block_is_the_jax_choice(R):
    assert tdirect.pick_trisolve_block(R) == jdirect.pick_trisolve_block(R)


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_lu_matches_jax(dt):
    A = tmodels.advection_diffusion_2d(10)
    dec = tdecompose(A, tmodels.generate_rhs(A.n), tcfg.Settings(overlap=2),
                     4)
    vals, cols = dec.lmat_vals.astype(dt), dec.lmat_cols
    b = np.random.default_rng(5).standard_normal(
        dec.local_rhs.shape).astype(dt)
    luj, pivj = jdirect.lu_factor(jnp.asarray(vals), jnp.asarray(cols))
    lut, pivt = tdirect.lu_factor(torch.from_numpy(vals),
                                  torch.from_numpy(cols))
    # LAPACK's 1-based pivots against the JAX package's 0-based ones
    np.testing.assert_array_equal(pivt.numpy() - 1, np.asarray(pivj))
    assert _normwise(lut, luj) <= TOL[dt]
    assert _normwise(tdirect.lu_solve((lut, pivt), torch.from_numpy(b)),
                     jdirect.lu_solve((luj, pivj), jnp.asarray(b))
                     ) <= TOL[dt]


@pytest.fixture(scope="module")
def nonsym_batch():
    A = tmodels.advection_diffusion_2d(10)
    dec = tdecompose(A, tmodels.generate_rhs(A.n), tcfg.Settings(overlap=3),
                     4)
    return dec.lmat_vals, dec.lmat_cols, dec.local_rhs


@pytest.mark.parametrize("tol,max_iters,restart,jacobi", [
    (1e-10, 200, 8, False),    # restarts, every subdomain to its tolerance
    (1e-12, 20, 6, True),      # the total-iteration cap ends every solve
])
def test_gmres_solve_matches_jax(nonsym_batch, tol, max_iters, restart,
                                 jacobi):
    vals, cols, b = nonsym_batch
    x0 = np.zeros_like(b)
    dinv = jacobi_inverse(vals, cols) if jacobi else None
    rj = jgmres(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(b),
                jnp.asarray(x0), tol, max_iters, restart=restart,
                precond=(None if dinv is None
                         else lambda r: jnp.asarray(dinv) * r))
    td = None if dinv is None else torch.from_numpy(dinv)
    rt = tgmres(torch.from_numpy(vals), torch.from_numpy(cols),
                torch.from_numpy(b), torch.from_numpy(x0), tol, max_iters,
                restart=restart,
                precond=None if td is None else (lambda r: td * r))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    assert rt.iters.max() <= max_iters
    assert _normwise(rt.x, rj.x) <= 1e-10
    np.testing.assert_allclose(rt.rel_resnorm.numpy(),
                               np.asarray(rj.rel_resnorm), rtol=1e-6,
                               atol=1e-14)


SOLVES = {
    # GMRES locals on a non-symmetric operator, restarted (up to 30 inner
    # iterations at restart 20), with Jacobi.  With a budget that stops
    # the warm-started inner solve far from its tolerance (30 at
    # restart 8, tolerance 1e-8) the solution form amplifies the two
    # packages' rounding tenfold an outer iteration, in either package
    "gmres": (12, 4, dict(problem="advection_diffusion_2d", overlap=2,
                          local_solver="gmres", restart_iter=20,
                          local_max_iters=40, local_tolerance=1e-6,
                          precond="jacobi")),
    "cholesky": (16, 4, dict(overlap=2, local_solver="cholesky")),
    "cholesky_inverse": (16, 4, dict(overlap=2, local_solver="cholesky",
                                     direct_apply="inverse")),
    "cholesky_blocked": (16, 4, dict(overlap=3, local_solver="cholesky",
                                     direct_apply="blocked",
                                     row_pad_multiple=16)),
    "lu": (12, 4, dict(problem="advection_diffusion_2d", overlap=2,
                       local_solver="lu")),
    # O-RAS factors are built from the Robin-modified operator
    "cholesky_oras": (16, 4, dict(overlap=2, local_solver="cholesky",
                                  oras_weight=-0.5)),
    # the inner operator without its ELL remainder (a 2-D partition keeps
    # one), in the correction form
    "dia_only": (16, 4, dict(overlap=3, partition="regular2d",
                             spmv_format="dia", inner_operator="dia_only",
                             criterion="residual_based",
                             local_max_iters=20)),
    "split_direct": (16, 4, dict(overlap=2, local_solver="cholesky",
                                 direct_apply="inverse",
                                 overlap_split=True)),
    "split_cg": (16, 4, dict(overlap=2, overlap_split=True,
                             local_max_iters=20)),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(name):
    n, S, kw = SOLVES[name]
    js, ts = both(n, S, tolerance=1e-6, max_iters=300, **kw)
    # the split's warm-started correction solves hover at their threshold
    check_histories(js.run(), ts.run(), inner=name != "split_cg")
    if "overlap_split" in kw:
        np.testing.assert_allclose(ts._plan["z_base"].numpy(),
                                   np.asarray(js._plan["z_base"]),
                                   rtol=0, atol=1e-12)


def test_dia_only_changes_the_inner_operator():
    """dia_only is a different inner operator, not a layout: the inner
    iteration counts differ from the exact operator's."""
    _, exact = both(16, 4, tolerance=1e-6, max_iters=300,
                    **dict(SOLVES["dia_only"][2], inner_operator="exact"))
    _, cut = both(16, 4, tolerance=1e-6, max_iters=300,
                  **SOLVES["dia_only"][2])
    assert cut._local.dia_has_remainder
    re, rc = exact.run(), cut.run()
    assert re.converged and rc.converged
    assert not np.array_equal(re.inner_iters_history, rc.inner_iters_history)


@pytest.mark.parametrize("kw,match", [
    (dict(local_solver="cholesky", direct_apply="fast"), "direct_apply"),
    (dict(local_solver="lu", direct_apply="inverse"), "cholesky"),
    (dict(local_solver="cholesky", overlap_split=True), "overlap_split"),
    (dict(overlap_split=True, oras_weight=-0.5), "O-RAS"),
    (dict(overlap_split=True, criterion="residual_based"), "solution-based"),
    (dict(overlap_split=True, local_compute_dtype="float32"),
     "solution-based"),
    (dict(inner_operator="dia_only", spmv_format="dia"), "residual-based"),
    (dict(local_solver="gmres", fused_local_cg=True), "local_solver='cg'"),
    # the CPU keeps the ELL operator under spmv_format='auto'
    (dict(fused_local_cg=True), "requires the DIA operator"),
])
def test_gates_raise_like_jax(kw, match):
    A = tmodels.laplacian_2d(8)
    b = tmodels.generate_rhs(A.n)
    with pytest.raises(ValueError, match=match):
        JSolver(jdecompose(A, b, settings(jcfg, **kw), 2))
    with pytest.raises(ValueError, match=match):
        TSolver(tdecompose(A, b, settings(tcfg, **kw), 2), device="cpu")


def test_direct_plan_frees_all_but_the_inverse():
    """With the explicit inverse the plan keeps the inverse alone; built
    with the spans recorded, the factor and the inverse are one set-up
    span each, inside the solver's."""
    prev = timing.recording(True)
    timing.clear_spans()
    try:
        _, ts = both(16, 4, **SOLVES["cholesky_inverse"][2])
        spans = timing.spans()
    finally:
        timing.recording(prev)
        timing.clear_spans()
    assert "factor_inv" in ts._plan and "factor_L" not in ts._plan
    steps = [s for s in spans if s.name in ("factor", "inverse")]
    assert [s.name for s in steps] == ["factor", "inverse"]
    for s in steps:
        assert spans[s.parent].name == "solver_setup" and s.solve == 0
        assert s.end_ns > s.start_ns
    _, tl = both(12, 4, problem="advection_diffusion_2d", local_solver="lu")
    assert {"factor_lu", "factor_piv"} <= set(tl._plan)


# float32 Cholesky locals (explicit inverse) under a float64 outer loop:
# the correction form refines to the float64 target in both packages, with
# equal counts (96 at 32^2 on 4 strips) and histories that differ by the
# float32 factor's rounding: 1.28e-5 relative read on this configuration
F32_LOCALS_RTOL = 3e-5


def test_f32_direct_locals_refine_like_jax():
    kw = dict(overlap=2, local_solver="cholesky", direct_apply="inverse",
              local_compute_dtype="float32", tolerance=1e-8, max_iters=200)
    js, ts = both(32, 4, **kw)
    rj, rt = js.run(), ts.run()
    assert ts._plan["factor_inv"].dtype == torch.float32
    check_histories(rj, rt, rtol=F32_LOCALS_RTOL, floor=1e-8)
    assert rt.relative_residual_norm <= 1e-8


def test_f32_throughout_direct_locals_never_detect():
    """With float32 throughout the stationary iteration stalls far above
    1e-8 in both packages (4.7e-6 and 8.3e-6 of the first residual after
    200 iterations; it is there after 100)."""
    kw = dict(overlap=2, local_solver="cholesky", direct_apply="inverse",
              dtype="float32", tolerance=1e-8, max_iters=100)
    js, ts = both(16, 4, **kw)
    rj, rt = js.run(), ts.run()
    assert not rj.converged and not rt.converged
    assert rj.iters == rt.iters == 100
    for r in (rj, rt):
        h = r.global_resnorm_history
        assert h[-1] > 1e-7 * h[0]
