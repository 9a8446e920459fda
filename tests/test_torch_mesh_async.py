"""The port's one-sided exchange, free-running solvers and checkpoints
across processes (``tests/torch_mesh_async_worker.py`` in a gloo group of 2
CPU processes) against the port in one process and the JAX package.

On the CPU the one-sided ``rdma`` transport across processes is K4's plain
version with ``Mesh.shift``, and the free-running tiers' plain versions
take their neighbours' messages through ``Mesh.shift`` (1-D) or one
``Mesh.all_gather`` a round (2-D, general): the lockstep emulation of one
process, so every result equals the single-process port's bit for bit.

Bars against the JAX package, as in the single-process files: the
synchronous solves (``laplacian_2d(16)``, overlap 3, float64, tolerance
1e-6, 8 ranks) with equal counts and histories within rtol 1e-8 plus 1e-12
of the largest entry (JAX's K4 in interpret mode on its 8-device CPU mesh);
the free-running tiers with x within 1e-4 * max|x| and ``done_at`` equal.
A checkpoint written across processes loads in the JAX package and resumes
there to its straight run.
"""

import os

import jax
import numpy as np
import pytest

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.ops.async_ras import AsyncRASolver as JAsync
from schwarz_tpu.ops.async_ras_2d import AsyncRASolver2D as J2D
from schwarz_tpu.ops.async_ras_general import AsyncGeneralRASolver as JGen
from schwarz_tpu.parallel.mesh import make_mesh as jmake_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.core.partition import partition_metis
from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
from schwarz_tpu_torch.parallel.convergence import ConvState
from schwarz_tpu_torch.ras import STATE_KEYS, RASolver
from schwarz_tpu_torch.ras import solve as tsolve
from torch_mesh_async_worker import (BASE, D, FREE_1D, FREE_1D_ROUNDS,
                                     FREE_2D, FREE_2D_ROUNDS, FREE_GEN,
                                     FREE_GEN_ROUNDS, HALF, RDMA, run_group)

BAR = 1e-4          # free-running x within BAR * max|x| of the JAX package's
NPROC = 2
# per process: its rank, its block of a checkpoint, its longest K4 wait
PER_PROCESS = ("pid", "ck_block", "k4.longest_wait_ns")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 2-process group's outputs and its directory; a single-process
    port checkpoint (HALF iterations) is written there first for the
    workers to resume."""
    d = tmp_path_factory.mktemp("mesh_async")
    A, b = _problem(tmodels)
    half = RASolver(tdecompose(A, b, _settings(tcfg, max_iters=HALF), D),
                    device="cpu", num_ranks=D)
    half.run(checkpoint_path=str(d / "single.npz"))
    outs = run_group(NPROC, str(d), "rdma,k4,free,ckpt", timeout_s=240)
    return outs, d


def _problem(models):
    A = models.laplacian_2d(16)
    return A, models.generate_rhs(A.n, random=False)


def _settings(cfg, strategy="all_gather", comm=None, **kw):
    comm = cfg.CommSettings(strategy=cfg.HaloStrategy(strategy),
                            **(comm or {}))
    return cfg.Settings(**{**BASE, **kw}, comm=comm)


_cache: dict = {}


def _once(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


def _jax_solver(**kw):
    A, b = _problem(jmodels)
    return JSolver(jdecompose(A, b, _settings(jcfg, **kw), D),
                   mesh=jmake_mesh(jax.devices()[:D]))


def _port_solver(**kw):
    A, b = _problem(tmodels)
    return RASolver(tdecompose(A, b, _settings(tcfg, **kw), D), device="cpu",
                    num_ranks=D)


def _same(o, name, r):
    """The worker's record ``name`` equals the result ``r`` bit for bit."""
    assert int(o[f"{name}.iters"]) == r.iters
    assert bool(o[f"{name}.converged"]) == r.converged
    np.testing.assert_array_equal(o[f"{name}.global"],
                                  r.global_resnorm_history)
    np.testing.assert_array_equal(o[f"{name}.local"],
                                  r.local_resnorm_history)
    np.testing.assert_array_equal(o[f"{name}.inner"], r.inner_iters_history)
    np.testing.assert_array_equal(o[f"{name}.solution"], r.solution)


def _close_to_jax(o, name, rj):
    assert int(o[f"{name}.iters"]) == rj.iters and rj.converged
    g, jg = o[f"{name}.global"], rj.global_resnorm_history
    np.testing.assert_allclose(g, jg, rtol=1e-8, atol=1e-12 * jg.max())
    jl = rj.local_resnorm_history
    np.testing.assert_allclose(o[f"{name}.local"], jl, rtol=1e-8,
                               atol=1e-12 * np.abs(jl).max())
    np.testing.assert_allclose(o[f"{name}.solution"], rj.solution, rtol=0,
                               atol=1e-10)


def test_every_process_returns_the_same(group):
    outs, _ = group
    first = outs[0]
    assert set(first) == set(outs[1])
    for k, v in first.items():
        if k not in PER_PROCESS:
            np.testing.assert_array_equal(outs[1][k], v, err_msg=k)


@pytest.mark.parametrize("variant", list(RDMA))
def test_rdma_across_processes_is_the_single_process_solve(group, variant):
    comm = RDMA[variant]
    r = _once(("port", variant), lambda: _port_solver(
        strategy="rdma", comm=comm).run())
    _same(group[0][0], f"rdma_{variant}", r)


@pytest.mark.parametrize("variant", list(RDMA))
def test_rdma_across_processes_matches_jax(group, variant):
    rj = _once(("jax", variant), lambda: _jax_solver(
        strategy="rdma", comm=RDMA[variant]).run())
    _close_to_jax(group[0][0], f"rdma_{variant}", rj)


def test_rdma_moves_the_neighbor_strategy_values(group):
    o = group[0][0]
    for v in RDMA:
        np.testing.assert_array_equal(o[f"rdma_{v}.global"],
                                      o["neighbor.global"])
        np.testing.assert_array_equal(o[f"rdma_{v}.solution"],
                                      o["neighbor.solution"])


def test_k4_exchange_across_processes_matches_plain(group):
    """Five launches of every kind on one set of sequence words: each
    process's halo values equal the plain rounds through ``Mesh.shift``,
    and the counts are the variants' (signals received, requests served)."""
    for o in group[0]:
        for i, (obo, get) in enumerate([(False, False), (False, True),
                                        (True, False), (True, True),
                                        (False, False)]):
            assert bool(o[f"k4_{i}.equal"]), i
            c = o[f"k4_{i}.counts"]
            assert (c[:, 1] == int(get)).all(), i
            # one signal a buffer, or one an element (H_k of them)
            assert (c[:, 0] == 1).all() if not obo else c[:, 0].max() > 1


def _free_refs(tier):
    """(port in one process, JAX) runs of a free-running configuration."""
    if tier == "1d":
        A, b = _problem(tmodels)
        Aj, _ = _problem(jmodels)
        t = AsyncRASolver(A, b, 4, num_ranks=4, device="cpu", **FREE_1D)
        j = JAsync(Aj, b, num_subdomains=4, mesh=jmake_mesh(
            jax.devices()[:4]), **FREE_1D)
        return t.run(max_rounds=FREE_1D_ROUNDS), j.run(
            max_rounds=FREE_1D_ROUNDS), j
    if tier == "2d":
        A, Aj = tmodels.laplacian_2d(16), jmodels.laplacian_2d(16)
        b = np.random.default_rng(11).uniform(0.5, 1.5, A.n)
        t = AsyncRASolver2D(A, b, num_ranks=4, device="cpu", **FREE_2D)
        j = J2D(Aj, b, mesh=jmake_mesh(jax.devices()[:4]), **FREE_2D)
        return t.run(max_rounds=FREE_2D_ROUNDS), j.run(
            max_rounds=FREE_2D_ROUNDS), j
    A, Aj = tmodels.laplacian_2d(12), jmodels.laplacian_2d(12)
    part = partition_metis(A, 4)
    b = np.ones(A.n)
    t = AsyncGeneralRASolver(A, b, 4, part=part, device="cpu", **FREE_GEN)
    j = JGen(Aj, b, 4, part=part, **FREE_GEN)
    return t.run(max_rounds=FREE_GEN_ROUNDS), j.run(
        max_rounds=FREE_GEN_ROUNDS), j


@pytest.mark.parametrize("tier", ["1d", "2d", "general"])
def test_free_running_across_processes(group, tier):
    """Each tier on 2 processes: x, done_at and the round counts equal the
    single-process plain run bit for bit, and the JAX package's within
    the single-process files' bar."""
    (xt, it), (xj, ij), _ = _once(("free", tier), lambda: _free_refs(tier))
    o = group[0][0]
    name = {"1d": "free_1d", "2d": "free_2d", "general": "free_general"}[tier]
    np.testing.assert_array_equal(o[f"{name}.x"], xt)
    np.testing.assert_array_equal(o[f"{name}.done_at"], it["done_at"])
    for k in ("rounds", "total_rounds", "converged"):
        if k in it:
            assert o[f"{name}.{k}"] == it[k], k
    np.testing.assert_array_equal(o[f"{name}.done_at"], ij["done_at"])
    assert float(np.abs(o[f"{name}.x"] - xj).max()) <= BAR * float(
        np.abs(xj).max())
    assert bool(o[f"{name}.converged"])


def test_run_refined_across_processes(group):
    A, b = _problem(tmodels)
    s = AsyncRASolver(A, b, 4, num_ranks=4, device="cpu",
                      **{**FREE_1D, "tolerance": 1e-4, "ninner": 20,
                         "chunk_rounds": 16})
    x, info = s.run_refined(tol=1e-8, max_rounds=400)
    o = group[0][0]
    np.testing.assert_array_equal(o["refined.x"], x)
    assert float(o["refined.rel"]) == info["relative_residual_norm"] <= 1e-8
    assert int(o["refined.restarts"]) == info["restarts"]


def test_checkpoint_across_processes_resumes_bit_for_bit(group):
    """Stopped at HALF iterations on 2 processes, the checkpoint resumed on
    2 processes gives the straight run's histories and solution."""
    o = group[0][0]
    assert int(o["ck_half.iters"]) == HALF
    assert int(o["ck_straight.iters"]) > HALF
    for k in ("iters", "global", "local", "inner", "solution"):
        np.testing.assert_array_equal(o[f"ck_resumed.{k}"],
                                      o[f"ck_straight.{k}"], err_msg=k)
    _same(o, "ck_straight", _once("port_straight", lambda: _port_solver(
    ).run()))


def test_checkpoint_across_processes_loads_in_jax(group):
    """The JAX package resumes the file written across processes to its
    straight run's count and history."""
    outs, d = group
    js = _jax_solver()
    straight = _once("jax_straight", js.run)
    r = js.run(resume_state=js.load_checkpoint(str(d / "half.npz")))
    assert r.converged and r.iters == straight.iters
    g = straight.global_resnorm_history
    np.testing.assert_allclose(r.global_resnorm_history, g, rtol=1e-8,
                               atol=1e-12 * g.max())
    _close_to_jax(outs[0], "ck_resumed", straight)


def test_checkpoint_holds_the_whole_state_in_blocks(group):
    """The file holds every subdomain; each process loaded its block."""
    outs, d = group
    at = len(ConvState._fields) - 1 + STATE_KEYS.index("x_own")
    with np.load(str(d / "half.npz")) as f:
        x_own = f[f"arr_{at}"]
    assert x_own.shape[0] == D
    np.testing.assert_array_equal(
        np.concatenate([o["ck_block"] for o in outs]), x_own)
    assert os.path.exists(d / "schwarz_debug_out.npz")
    with np.load(str(d / "schwarz_debug_out.npz")) as f:
        assert f[f"arr_{at}"].shape == x_own.shape


def test_single_process_checkpoint_resumes_across_processes(group):
    o = group[0][0]
    for k in ("iters", "global", "local", "inner", "solution"):
        np.testing.assert_array_equal(o[f"ck_single.{k}"],
                                      o[f"ck_straight.{k}"], err_msg=k)


def test_fgmres_checkpoint_across_processes(group):
    """One restart cycle, its checkpoint, and the rest across processes:
    the straight FGMRES run; the file resumes in the JAX package too."""
    outs, d = group
    o = outs[0]
    for k in ("iters", "global", "solution"):
        np.testing.assert_array_equal(o[f"fg_resumed.{k}"],
                                      o[f"fg_straight.{k}"], err_msg=k)
    js = _jax_solver(accelerator="fgmres", restart_iter=4)
    straight = js.run_accelerated()
    r = js.run_accelerated(resume_state=js.load_accel_checkpoint(
        str(d / "fgmres.npz")))
    assert r.iters == straight.iters == int(o["fg_straight.iters"])
    g = straight.global_resnorm_history
    np.testing.assert_allclose(r.global_resnorm_history, g, rtol=1e-8,
                               atol=1e-12 * g.max())
    np.testing.assert_allclose(o["fg_straight.global"], g, rtol=1e-8,
                               atol=1e-12 * g.max())


def test_free_running_checkpoint_across_processes(group):
    """The 1-D tier stopped after one launch and resumed across processes:
    the straight run bit for bit; the file resumes in the JAX package to
    its straight run's done_at."""
    outs, d = group
    o = outs[0]
    np.testing.assert_array_equal(o["fr_resumed.x"], o["fr_straight.x"])
    np.testing.assert_array_equal(o["fr_resumed.done_at"],
                                  o["fr_straight.done_at"])
    assert int(o["fr_resumed.total_rounds"]) == int(
        o["fr_straight.total_rounds"])
    _, (xj, ij), js = _once(("free", "1d"), lambda: _free_refs("1d"))
    xr, ir = js.run(max_rounds=FREE_1D_ROUNDS - FREE_1D["chunk_rounds"],
                    resume_state=js.load_checkpoint(str(d / "free")))
    np.testing.assert_array_equal(ir["done_at"], ij["done_at"])
    assert float(np.abs(xr - o["fr_resumed.x"]).max()) <= BAR * float(
        np.abs(xr).max())


def test_free_running_solve_takes_a_mesh(group):
    """``solve(free_running=True, mesh=)`` with a mesh of one process: the
    tier its 4 ranks pick is the one ``num_ranks=4`` picks, and the solve
    converges (the 2-process case is ``tests/test_torch_mesh.py``'s
    ``free_running``)."""
    from schwarz_tpu_torch.parallel.mesh import Mesh
    from schwarz_tpu_torch.ras import free_running_tier

    A = tmodels.laplacian_2d(16)
    s = tcfg.Settings(free_running=True)
    mesh = Mesh(num_ranks=4)
    assert free_running_tier(A, 4, s, num_ranks=mesh.num_ranks) == \
        free_running_tier(A, 4, s, num_ranks=4)
    r = tsolve(A, np.ones(A.n), tcfg.Settings(free_running=True,
                                              tolerance=1e-4), 4,
               mesh=Mesh(num_ranks=4))
    assert r.converged


def test_window_of_one_process_is_its_own_buffer():
    """The window of one process makes no IPC call: a zeroed buffer whose
    table is its own address; the rings' layout leaves the sequence words,
    acks, error word and longest wait in order, 8-byte aligned."""
    from schwarz_tpu_torch.ops.rank_rings import ring_layout
    from schwarz_tpu_torch.parallel.mesh import LocalWindow

    w = LocalWindow(64, "cpu")
    assert w.table.tolist() == [w.ptr]
    assert w.read(0, 0, 64) == bytes(64)
    w.buffer[8:16] = 7
    w.zero(8, 8)
    assert w.read(0, 0, 64) == bytes(64)
    lay = ring_layout(Dl=3, ND=2, M=4, slot=131)
    assert lay.seq_off >= 4 * 3 * 2 * 4 * 131 and lay.seq_off % 8 == 0
    assert lay.ack_off == lay.seq_off + 8 * 3 * 2 * 4
    assert lay.err_off >= lay.ack_off + 4 * 3 * 2 and lay.err_off % 8 == 0
    assert lay.nbytes == lay.err_off + 16
