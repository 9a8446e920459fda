"""The port's P1 FEM generators (``models/fem_assembly.py``, a numpy copy of
the JAX package's) against the JAX package's: bit-identical operators,
right-hand sides, node coordinates and cell weights, and one weighted
metis solve of a refined system through both packages (equal iteration
counts, histories within rtol 1e-8 plus 1e-12 of the largest entry at
outer tolerance 1e-6)."""

import numpy as np
import pytest

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
from schwarz_tpu.ras import solve as jsolve
import schwarz_tpu_torch as tpkg
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.ras import solve as tsolve

GENERATORS = [
    ("fem_p1_poisson", 6, dict(refine_levels=1)),
    ("fem_p1_poisson", 8, dict(refine_levels=2, eps=50.0, theta=0.5)),
    ("fem_p1_poisson", 7, dict(refine_levels=2, refine_at=(1.0, 0.5),
                               refine_fraction=0.4)),
    ("fem_p1_advection", 8, dict(refine_cycles=1)),
    ("fem_p1_advection", 10, dict(refine_cycles=2)),
    ("fem_p1_elasticity", 6, {}),
    ("fem_p1_elasticity", 9, dict(lam=2.0, mu=0.5)),
]


def _identical(a, b):
    assert type(a) is np.ndarray and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,n,kw", GENERATORS)
def test_generators_bit_identical(name, n, kw):
    Aj, bj, cj, wj = getattr(jmodels, name)(n, **kw)
    At, bt, ct, wt = getattr(tmodels, name)(n, **kw)
    assert At.n == Aj.n
    for f in ("row_ptrs", "col_idxs", "values"):
        _identical(getattr(At, f), getattr(Aj, f))
    for t, j in ((bt, bj), (ct, cj), (wt, wj)):
        _identical(t, j)


def test_exports_match_jax():
    import schwarz_tpu

    for name in ("fem_p1_poisson", "fem_p1_advection", "fem_p1_elasticity",
                 "helmholtz_2d"):
        assert name in tmodels.__all__ and name in jmodels.__all__
        assert getattr(tmodels, name).__module__.startswith(
            "schwarz_tpu_torch.")
    # every name of the JAX package's top level exists in the port's
    missing = [n for n in schwarz_tpu.__all__ if not hasattr(tpkg, n)]
    assert not missing, missing
    A, B = jmodels.helmholtz_2d(6), tmodels.helmholtz_2d(6)
    np.testing.assert_array_equal(A.values, B.values)


def test_refined_fem_solve_with_cell_weights_matches_jax():
    A, rhs, _coords, wt = tmodels.fem_p1_poisson(10, refine_levels=2,
                                                 eps=10.0, theta=0.3)
    kw = dict(overlap=2, tolerance=1e-6, max_iters=400, dtype="float64")
    rj = jsolve(A, rhs, jcfg.Settings(partition=jcfg.Partition.metis, **kw),
                num_subdomains=4, cell_weights=wt)
    rt = tsolve(A, rhs, tcfg.Settings(partition=tcfg.Partition.metis, **kw),
                num_subdomains=4, cell_weights=wt, device="cpu")
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    hj = rj.global_resnorm_history[: rj.iters + 1]
    np.testing.assert_allclose(rt.global_resnorm_history, hj, rtol=1e-8,
                               atol=1e-12 * np.abs(hj).max())
    x = rj.solution
    assert np.linalg.norm(rt.solution - x) <= 1e-8 * np.linalg.norm(x)
