"""The port's synchronous solve with the neighbour / one-sided halo strategies,
the stale-halo modes and a halo dtype, against the JAX package on the CPU
mesh: the same matrix, rhs, Settings and rank count (``mesh`` of D devices
there, ``num_ranks=D`` here).  JAX runs its one-sided kernel in interpret
mode; the port runs the plain version of K4.

Float64 bar: equal iteration counts, global and local residual histories
within rtol 1e-8, solutions within atol 1e-12."""

import jax
import numpy as np
import pytest

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
import schwarz_tpu.models as jmodels
from schwarz_tpu.parallel.mesh import make_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.ras import RASolver as TSolver
from schwarz_tpu_torch.ras import solve as tsolve

# mode, one by one, flush discipline: tests/test_exchange.py's matrix
RDMA_VARIANTS = [
    ("put", False, "flush-all"),
    ("get", False, "flush-all"),
    ("put", True, "flush-all"),
    ("put", True, "flush-local"),
    ("get", True, "flush-local"),
]


def _settings(cfg, strategy="all_gather", partition="regular", comm=None,
              method="allgather", **kw):
    """The same Settings in either package (enum fields given by value)."""
    comm = cfg.CommSettings(strategy=cfg.HaloStrategy(strategy),
                            **(comm or {}))
    conv = cfg.ConvergenceSettings(method=cfg.GlobalConvergence(method))
    return cfg.Settings(partition=cfg.Partition(partition), comm=comm,
                        convergence=conv, **kw)


def _run_both(mats, S, D, **kw):
    Aj, At = mats
    b = jmodels.generate_rhs(Aj.n)
    rj = JSolver(jdecompose(Aj, b, _settings(jcfg, **kw), S),
                 mesh=make_mesh(jax.devices()[:D])).run()
    rt = TSolver(tdecompose(At, b, _settings(tcfg, **kw), S), device="cpu",
                 num_ranks=D).run()
    return rj, rt


def _lap(n):
    return jmodels.laplacian_2d(n), tmodels.laplacian_2d(n)


def _check(rj, rt, rtol=1e-8, atol=1e-12):
    assert rt.iters == rj.iters
    assert rt.converged == rj.converged and rt.diverged == rj.diverged
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=rtol)
    np.testing.assert_allclose(
        rt.local_resnorm_history, rj.local_resnorm_history, rtol=rtol,
        atol=rtol * np.abs(rj.local_resnorm_history).max())
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=0, atol=atol)


BASE = dict(overlap=3, tolerance=1e-6, max_iters=300)


@pytest.mark.parametrize("partition", ["regular", "regular2d", "metis"])
def test_neighbor_strategy_matches_jax(partition):
    rj, rt = _run_both(_lap(16), 4, 4, strategy="neighbor",
                       partition=partition, **BASE)
    assert rj.converged
    _check(rj, rt)


@pytest.mark.parametrize("mode,one_by_one,flush", RDMA_VARIANTS)
def test_rdma_strategy_matrix_matches_jax(mode, one_by_one, flush):
    comm = dict(enable_put=(mode == "put"), enable_get=(mode == "get"),
                enable_one_by_one=one_by_one, flush_type=flush)
    rj, rt = _run_both(_lap(12), 4, 4, strategy="rdma", comm=comm,
                       **{**BASE, "overlap": 2})
    assert rj.converged
    _check(rj, rt)


@pytest.mark.parametrize("strategy", ["neighbor", "rdma"])
def test_four_subdomains_per_rank_matches_jax(strategy):
    """Sl = 4: 8 subdomains on 2 ranks; most halo slots stay inside a
    rank.  The result also equals the one-rank-per-subdomain run."""
    rj, rt = _run_both(_lap(16), 8, 2, strategy=strategy, **BASE)
    assert rj.converged
    _check(rj, rt)
    A = tmodels.laplacian_2d(16)
    r8 = tsolve(A, tmodels.generate_rhs(A.n),
                _settings(tcfg, strategy=strategy, **BASE), 8, device="cpu")
    assert r8.iters == rt.iters
    np.testing.assert_array_equal(r8.solution, rt.solution)


@pytest.mark.parametrize("comm,strategy", [
    (dict(overlap_comm=True), "all_gather"),
    (dict(overlap_comm=True), "neighbor"),
    (dict(onesided=True, staleness=3), "all_gather"),
    (dict(onesided=True, staleness=3, enable_put=True, enable_get=False),
     "rdma"),
])
def test_stale_halo_modes_match_jax(comm, strategy):
    rj, rt = _run_both(_lap(16), 4, 4, strategy=strategy, comm=comm,
                       **{**BASE, "max_iters": 400})
    assert rj.converged
    _check(rj, rt)
    # stale halos cost iterations (tests/test_exchange.py:101-105)
    A = tmodels.laplacian_2d(16)
    fresh = tsolve(A, tmodels.generate_rhs(A.n), _settings(tcfg, **BASE), 4,
                   device="cpu")
    assert fresh.converged and rt.iters >= fresh.iters


@pytest.mark.parametrize("strategy,S,D", [("all_gather", 4, 4),
                                          ("neighbor", 4, 4),
                                          ("rdma", 8, 2)])
def test_halo_dtype_float32_matches_jax(strategy, S, D):
    """Halo values travel in float32 under a float64 solve: rtol 1e-5 (the
    float32 roundings are the same values in both packages, but they enter
    sums taken in another order)."""
    rj, rt = _run_both(_lap(16), S, D, strategy=strategy,
                       halo_dtype="float32", **{**BASE, "tolerance": 1e-4})
    assert rj.converged
    _check(rj, rt, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("kw,match", [
    (dict(two_level=True, comm=dict(overlap_comm=True)),
     "two_level requires fresh halos"),
    (dict(two_level=True, comm=dict(onesided=True, staleness=2)),
     "two_level requires fresh halos"),
    (dict(comm=dict(overlap_comm=True, onesided=True, staleness=2)),
     "enable_overlap is the one-iteration-stale halo pipeline"),
])
def test_stale_halo_refusals_match_jax(kw, match):
    Aj, At = _lap(8)
    b = jmodels.generate_rhs(Aj.n)
    with pytest.raises(ValueError, match=match) as ej:
        JSolver(jdecompose(Aj, b, _settings(jcfg, **kw), 2))
    with pytest.raises(ValueError, match=match) as et:
        TSolver(tdecompose(At, b, _settings(tcfg, **kw), 2), device="cpu")
    assert str(et.value) == str(ej.value)


def test_num_ranks_must_divide_subdomains():
    A = tmodels.laplacian_2d(8)
    dec = tdecompose(A, tmodels.generate_rhs(A.n), tcfg.Settings(), 4)
    with pytest.raises(ValueError, match="must be divisible by mesh size 3"):
        TSolver(dec, device="cpu", num_ranks=3)
    solver = TSolver(dec, device="cpu", num_ranks=2)
    assert solver.num_ranks == 2 and solver.Sl == 2
    assert solver.neighbor_locality().shape == (4, 4)
    assert solver.neighbor_locality().all()
    assert TSolver(dec, device="cpu").num_ranks == 4


@pytest.mark.parametrize("strategy", ["all_gather", "neighbor"])
def test_baseline_config1_ani3_matches_jax(strategy):
    """BASELINE.json config 1: ani3_crop, regular 1-D partition, 2
    subdomains, CG locals, synchronous RAS
    (tests/test_baseline_configs.py).  Histories within rtol 1e-7: on this
    anisotropic operator the last two of 34 entries, six orders below the
    first, differ by 7e-13 absolute (3.5e-8 relative) between the packages,
    whose inner CG sums in another order; the strategies agree exactly."""
    mats = (jmodels.read_mtx(jmodels.matrix_path("ani3_crop.mtx")),
            tmodels.read_mtx(tmodels.matrix_path("ani3_crop.mtx")))
    rj, rt = _run_both(mats, 2, 2, strategy=strategy, overlap=3,
                       tolerance=1e-6)
    assert rj.converged and rt.relative_residual_norm < 1e-4
    _check(rj, rt, rtol=1e-7)


def test_baseline_config3_poisson_onesided_matches_jax():
    """BASELINE.json config 3 at its test size: 2-D Poisson, regular 2-D
    partition, 16 subdomains, one-sided gathered halos, decentralized
    detection."""
    rj, rt = _run_both(
        _lap(32), 16, 8, partition="regular2d", method="decentralized",
        comm=dict(onesided=True, staleness=1),
        **{**BASE, "max_iters": 400})
    assert rj.converged and rt.relative_residual_norm < 1e-4
    _check(rj, rt)
