"""The port's synchronous solve across processes (``parallel/mesh.py`` over a
gloo group) against the JAX package.

Each group of 2 or 4 CPU processes (``tests/torch_mesh_worker.py``, PyTorch
only) deals 8 ranks, one subdomain each, to its processes and runs the
mesh's collectives and a set of solves on ``laplacian_2d(16)``, overlap 3,
float64, tolerance 1e-6 (the configuration of ``tests/distributed_worker.py``
at the tolerance the ROADMAP's traps give for histories).  This process
runs the same Settings through the JAX package on its 8-device CPU mesh and
through the port in one process on 8 ranks.

Bars: every process returns the same result; iteration counts equal the
JAX package's, histories within rtol 1e-8 plus 1e-12 of the largest entry
(float32 locals through K3's plain version: 4e-6, twice the local
history's reading 2.0e-6); where no sum crosses the processes (every case but FGMRES: the
coarse CG runs on the whole A_c in every process) the histories equal the
single-process port's bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.parallel.mesh import make_mesh as jmake_mesh
from schwarz_tpu.parallel.neighbor_exchange import (
    build_neighbor_plan as jbuild_neighbor_plan)
from schwarz_tpu.ras import solve as jsolve
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.parallel.mesh import Mesh, make_mesh
from schwarz_tpu_torch.parallel.neighbor_exchange import (
    build_neighbor_plan as tbuild_neighbor_plan)
from schwarz_tpu_torch.ras import RASolver
from schwarz_tpu_torch.ras import solve as tsolve
from torch_mesh_worker import FREE_TOL, RTOL, run_group

D = 8
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' outputs, each group run once for the module."""
    out = {}
    for nproc in (2, 4):
        d = tmp_path_factory.mktemp(f"mesh{nproc}")
        out[nproc] = run_group(nproc, str(d), timeout_s=TIMEOUT_S)
    return out


def _settings(cfg, strategy="all_gather", method="allgather", **kw):
    if "precond" in kw:
        kw["precond"] = cfg.Precond(kw["precond"])
    return cfg.Settings(
        overlap=3, tolerance=1e-6, max_iters=300, dtype="float64",
        comm=cfg.CommSettings(strategy=cfg.HaloStrategy(strategy)),
        convergence=cfg.ConvergenceSettings(
            method=cfg.GlobalConvergence(method)), **kw)


TWO = dict(two_level=True, coarse_aggregates=2, coarse_space="spectral")
# the worker's cases (tests/torch_mesh_worker.py CASES) as Settings fields
CASES = {
    "neighbor": dict(strategy="neighbor"),
    "all_gather": {},
    "two_level_cg": dict(strategy="neighbor", coarse_solver="cg", **TWO),
    "two_level_dense": TWO,
    "fgmres": dict(accelerator="fgmres"),
    "fused_cg": dict(strategy="neighbor", local_compute_dtype="float32",
                     spmv_format="dia", row_pad_multiple=128,
                     fused_local_cg=True, precond="jacobi",
                     local_tolerance=1e-6),
    "tree": dict(method="tree"),
    "decentralized": dict(method="decentralized"),
    "allreduce": dict(method="allreduce"),
}
# the cases whose histories no cross-process sum enters (FGMRES's dots
# add the processes' partial sums)
EXACT = ("neighbor", "all_gather", "two_level_dense", "two_level_cg",
         "fused_cg", "tree", "decentralized", "allreduce")


def _problem(models):
    A = models.laplacian_2d(16)
    return A, models.generate_rhs(A.n, random=False)


_jax_cache: dict = {}
_port_cache: dict = {}


def _jax(case):
    if case not in _jax_cache:
        A, b = _problem(jmodels)
        _jax_cache[case] = jsolve(A, b, _settings(jcfg, **CASES[case]), D,
                                  mesh=jmake_mesh(jax.devices()[:D]))
    return _jax_cache[case]


def _port(case):
    if case not in _port_cache:
        A, b = _problem(tmodels)
        _port_cache[case] = tsolve(A, b, _settings(tcfg, **CASES[case]), D,
                                   device="cpu", num_ranks=D)
    return _port_cache[case]


def _check_case(outs, case):
    rj, rt = _jax(case), _port(case)
    first = outs[0]
    for o in outs[1:]:                       # every process, the same result
        for k in ("iters", "global", "local", "inner", "solution"):
            np.testing.assert_array_equal(o[f"{case}.{k}"],
                                          first[f"{case}.{k}"])
    assert bool(first[f"{case}.converged"]) and rj.converged
    assert int(first[f"{case}.iters"]) == rj.iters
    g, loc = first[f"{case}.global"], first[f"{case}.local"]
    jl = rj.local_resnorm_history
    rtol = RTOL.get(case, 1e-8)
    np.testing.assert_allclose(g, rj.global_resnorm_history, rtol=rtol,
                               atol=1e-12 * rj.global_resnorm_history.max())
    np.testing.assert_allclose(loc, jl, rtol=rtol,
                               atol=1e-12 * np.abs(jl).max())
    np.testing.assert_allclose(first[f"{case}.solution"], rj.solution,
                               rtol=0, atol=1e-10)
    assert float(first[f"{case}.rel"]) < 1e-5
    if case in EXACT:
        np.testing.assert_array_equal(g, rt.global_resnorm_history)
        np.testing.assert_array_equal(loc, rt.local_resnorm_history)
        np.testing.assert_array_equal(first[f"{case}.inner"],
                                      rt.inner_iters_history)
        np.testing.assert_array_equal(first[f"{case}.solution"], rt.solution)


@pytest.mark.parametrize("nproc", [2, 4])
def test_mesh_primitives(groups, nproc):
    outs = groups[nproc]
    G = np.arange(D * 3, dtype=np.float64).reshape(D, 3)
    for o in outs:
        np.testing.assert_array_equal(o["all_gather"], G)
        np.testing.assert_array_equal(o["process_allgather"], G + 1)
        np.testing.assert_array_equal(o["bf16"], G)
        assert float(o["psum"]) == nproc * (nproc + 1) / 2
    for r in range(-D - 1, D + 2):
        got = np.concatenate([o[f"shift_{r}"] for o in outs])
        np.testing.assert_array_equal(
            got, torch.roll(torch.from_numpy(G), r, 0).numpy(), err_msg=r)


@pytest.mark.parametrize("nproc", [2, 4])
def test_neighbor_solve_matches_jax(groups, nproc):
    _check_case(groups[nproc], "neighbor")


@pytest.mark.parametrize("case", ["all_gather", "two_level_dense",
                                  "two_level_cg", "fgmres", "fused_cg"])
def test_two_process_solves_match_jax(groups, case):
    _check_case(groups[2], case)


def test_two_level_cg_coarse_takes_no_more_iterations(groups):
    first = groups[2][0]
    assert int(first["two_level_cg.iters"]) <= int(first["neighbor.iters"])


@pytest.mark.parametrize("case", ["tree", "decentralized", "allreduce"])
def test_four_process_protocols_match_jax(groups, case):
    _check_case(groups[4], case)


@pytest.mark.parametrize("nproc", [2, 4])
def test_plan_and_locality_across_processes(groups, nproc):
    A, b = _problem(jmodels)
    dec = jdecompose(A, b, _settings(jcfg, strategy="neighbor"), D)
    proc = [d // (D // nproc) for d in range(D)]
    nx = jbuild_neighbor_plan(dec, D, process_of=proc)
    for o in groups[nproc]:
        assert o["offsets"].tolist() == list(nx.offsets)
        assert o["round_is_dcn"].tolist() == list(nx.round_is_dcn)
        # rounds within a process come first
        dcn = o["round_is_dcn"].tolist()
        assert any(dcn) and all(dcn[dcn.index(True):])
        np.testing.assert_array_equal(
            o["locality"], np.equal.outer(proc, proc))


@pytest.mark.parametrize("what", ["rdma", "free_running", "checkpoint",
                                  "resume", "load", "fgmres_checkpoint"])
def test_multi_process_refusals(groups, what):
    """What the port once refused across processes runs there, as the JAX
    package's multi-controller mesh does: the one-sided exchange moves the
    neighbour strategy's values (its history bit for bit), free-running
    returns the single process's solution, and the checkpoints hold the
    whole state (``tests/test_torch_mesh_async.py`` holds each to the JAX
    package)."""
    outs = groups[2]
    if what == "free_running":
        A, b = _problem(tmodels)
        one = tsolve(A, b, tcfg.Settings(
            overlap=3, tolerance=FREE_TOL, max_iters=300, dtype="float64",
            free_running=True), D, device="cpu", num_ranks=D)
    for o in outs:
        if what == "rdma":
            np.testing.assert_array_equal(o["ok.rdma"], o["neighbor.global"])
        elif what == "free_running":
            assert bool(o["ok.free_running_converged"])
            np.testing.assert_array_equal(o["ok.free_running"], one.solution)
        elif what == "checkpoint":
            np.testing.assert_array_equal(o["ok.checkpoint"],
                                          o["neighbor.global"])
        elif what == "resume":
            assert int(o["ok.resume"]) == int(o["neighbor.iters"])
        elif what == "load":
            # each process holds its block of the whole iterate
            whole = np.concatenate([q["ok.load"] for q in outs])
            assert whole.shape[0] == D and o["ok.load"].shape[0] == D // 2
            assert np.abs(whole).max() > 0
        else:
            assert int(o["ok.fgmres_checkpoint"]) == int(o["fgmres.iters"])
            whole = np.concatenate([q["ok.fgmres_load"] for q in outs])
            assert whole.shape[0] == D


def test_locality_aware_plan_tables_match_jax():
    """The intra-process-first plan for 8 ranks on 2 processes, every
    table, against the JAX package (``tests/test_multihost.py:82-126``)."""
    proc = [0] * 4 + [1] * 4
    Aj, b = _problem(jmodels)
    At, _ = _problem(tmodels)
    s = dict(overlap=3)
    nj = jbuild_neighbor_plan(jdecompose(Aj, b, jcfg.Settings(**s), D), D,
                              process_of=proc)
    nt = tbuild_neighbor_plan(tdecompose(At, b, tcfg.Settings(**s), D), D,
                              process_of=proc)
    assert nt.offsets == list(nj.offsets)
    assert nt.round_is_dcn == list(nj.round_is_dcn)
    # a 1-D chain on 2 processes: every offset crosses the 3-4 link
    assert any(nt.round_is_dcn)
    assert len(nt.send_idx) == len(nj.send_idx)
    for a, c in zip(nt.send_idx, nj.send_idx):
        np.testing.assert_array_equal(a, np.asarray(c))
    for k in ("is_local", "local_src", "recv_round", "recv_pos"):
        np.testing.assert_array_equal(getattr(nt, k),
                                      np.asarray(getattr(nj, k)), err_msg=k)
    assert nt.max_h == nj.max_h


def test_one_process_mesh_is_the_single_process_path():
    """A mesh of one process takes ``num_ranks``' path bit for bit, and
    makes no collective."""
    A, b = _problem(tmodels)
    mesh = make_mesh(num_ranks=4, device="cpu")
    assert mesh.num_processes == 1 and mesh.process_of == (0,) * 4
    s = _settings(tcfg, strategy="neighbor", **TWO)
    r1 = tsolve(A, b, s, 8, mesh=mesh)
    r0 = tsolve(A, b, s, 8, device="cpu", num_ranks=4)
    assert r1.iters == r0.iters
    np.testing.assert_array_equal(r1.global_resnorm_history,
                                  r0.global_resnorm_history)
    np.testing.assert_array_equal(r1.solution, r0.solution)
    assert mesh.stats["calls"] == 0
    solver = RASolver(tdecompose(A, b, s, 8), mesh=mesh)
    assert solver._mesh is None and solver.S_local == 8
    assert solver.neighbor_locality().all()


def test_launch_kills_the_group_on_the_first_failure(tmp_path):
    """``launch`` returns the logs in process order; a process that fails
    has its peers killed at once instead of left waiting."""
    import sys
    import time

    from schwarz_tpu_torch.parallel.mesh import launch

    code = ("import sys, time; pid = int(sys.argv[1]); print('pid', pid, "
            "'of', sys.argv[2]); sys.stdout.flush(); {}")
    logs = launch([sys.executable, "-c", code.format("")], 3,
                  str(tmp_path / "ok"), 60)
    assert [ln.split()[:4] for ln in logs] == [
        ["pid", str(p), "of", "3"] for p in range(3)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"exit 3"):
        launch([sys.executable, "-c", code.format(
            "time.sleep(120 if pid != 1 else 0); sys.exit(3)")], 3,
            str(tmp_path / "bad"), 60)
    assert time.monotonic() - t0 < 30


def test_mesh_deals_ranks_to_processes():
    m = Mesh(num_ranks=8, num_processes=4, process_index=2)
    assert m.process_of == (0, 0, 1, 1, 2, 2, 3, 3)
    assert m.block(16) == slice(8, 12)
    with pytest.raises(ValueError):
        Mesh(num_ranks=6, num_processes=4)
    with pytest.raises(ValueError):
        m.block(6)
