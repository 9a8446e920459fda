"""The port's free-running asynchronous RAS on any graph and partition (K7)
against the JAX package's, on the CPU.

JAX runs ``AsyncGeneralRASolver`` on the 8-device CPU mesh with its Pallas
kernel in interpret mode; the port runs K7's plain PyTorch version, a
lockstep emulation of the free-running ranks.  A rank blocks on message t-B
exactly, so the rounds do not depend on timing and both must agree up to
float32 sums in another order (the JAX package multiplies dense operators,
the port sums a row's entries in slot order, and its dot products sum in
float64): the iterate within 1e-4 * max|x|, and ``done_at``, ``rounds``,
``total_rounds``, ``colors`` and the known bits equal.  Each JAX
configuration compiles for 12-35 s, so each runs once, from a module-scoped
fixture.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
import schwarz_tpu.models.fem as jfem
from schwarz_tpu.ops.async_ras_general import AsyncGeneralRASolver as JGen
import schwarz_tpu.ras as jras
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.models.fem as tfem
from schwarz_tpu_torch.core.partition import partition_metis
from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
import schwarz_tpu_torch.ras as tras

BAR = 1e-4        # x within BAR * max|x|: float32 sums in another order

OPERATORS = {
    "lap12": lambda m, f: m.laplacian_2d(12),
    "lap16": lambda m, f: m.laplacian_2d(16),
    "adv12": lambda m, f: f.advection_diffusion_2d(12),
    "ani3": lambda m, f: m.read_mtx(m.matrix_path("ani3_crop.mtx")),
}

# name: (operator, S, rounds, chunk, solver keywords); two launches each,
# the first case to convergence
CASES = {
    "metis4": ("lap12", 4, 400, 4, dict(tolerance=1e-3, ninner=8)),
    "B2": ("lap12", 4, 8, 4, dict(tolerance=1e-3, ninner=8, staleness=2)),
    "oras": ("lap12", 4, 8, 4, dict(tolerance=1e-3, ninner=8,
                                    oras_weight=-0.8)),
    "bicgstab": ("adv12", 4, 8, 4, dict(tolerance=1e-3, ninner=8,
                                        nonsym=True)),
    # at S = 8 some rank lacks a colour: its message to itself is skipped
    "metis8": ("lap16", 8, 8, 4, dict(tolerance=1e-3, ninner=8)),
    "ani3": ("ani3", 4, 16, 8, dict(tolerance=1e-3, ninner=24)),
}


def _load(path):
    with np.load(path + ".npz") as f:
        return [f[f"arr_{i}"] for i in range(4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of a case, each made once."""
    cache = {}

    def get(name):
        if name not in cache:
            op, S, rounds, chunk, kw = CASES[name]
            jm = OPERATORS[op](jmodels, jfem)
            tm = OPERATORS[op](tmodels, tfem)
            part = partition_metis(tm, S)
            b = np.ones(tm.n)
            d = tmp_path_factory.mktemp(name)
            ckj, ckt = str(d / "jax"), str(d / "torch")
            js = JGen(jm, b, S, overlap=2, chunk_rounds=chunk, part=part,
                      **kw)
            ts = AsyncGeneralRASolver(tm, b, S, overlap=2,
                                      chunk_rounds=chunk, part=part,
                                      device="cpu", **kw)
            first = None
            if name == "metis4":
                # the state after two launches, for the resume test
                first = str(d / "jax_first")
                js.run(max_rounds=2 * chunk, checkpoint_path=first)
            out_j = js.run(max_rounds=rounds, checkpoint_path=ckj)
            out_t = ts.run(max_rounds=rounds, checkpoint_path=ckt)
            cache[name] = dict(jax=out_j, torch=out_t, ckj=ckj, ckt=ckt,
                               ts=ts, first=first, tm=tm, b=b, part=part)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_rounds_match_jax(runs, name):
    r = runs(name)
    (xj, ij), (xt, it), ts = r["jax"], r["torch"], r["ts"]
    chunk = CASES[name][3]
    assert it["rounds"] == ij["rounds"] and it["rounds"] >= 2 * chunk
    np.testing.assert_array_equal(it["done_at"], ij["done_at"])
    for k in ("converged", "total_rounds", "colors"):
        assert it[k] == ij[k], k
    assert set(it) == set(ij)
    scale = float(np.abs(xj).max())
    assert scale > 0 and float(np.abs(xt - xj).max()) <= BAR * scale
    # the carried state in the JAX package's file format
    (Xj, knj, auxj, cyj), (Xt, knt, auxt, cyt) = (_load(r["ckj"]),
                                                  _load(r["ckt"]))
    for a, c in ((Xj, Xt), (knj, knt), (auxj, auxt), (cyj, cyt)):
        assert a.shape == c.shape and a.dtype == c.dtype
    ys = float(np.abs(Xj).max())
    assert float(np.abs(Xt - Xj).max()) <= BAR * ys
    assert float(np.abs(cyt - cyj).max()) <= BAR * ys
    assert np.abs(cyj).max() > 0               # the carry was filled
    np.testing.assert_array_equal(knt, knj)
    np.testing.assert_array_equal(auxt[:, 1:3], auxj[:, 1:3])
    np.testing.assert_array_equal(auxt[:, 4:], auxj[:, 4:])
    # rn0: the JAX package sums 128 * Rint float32 terms in float32, the
    # port in float64
    np.testing.assert_allclose(auxt[:, 0], auxj[:, 0], rtol=1e-4)
    if name == "metis4":
        assert it["converged"] and (it["done_at"] >= 0).all()
    if name == "metis8":
        p = ts.plan
        assert (p.tgt_subd == np.arange(p.S)[:, None]).any()


def test_resumes_a_jax_checkpoint(runs):
    """A state written by the JAX package after two launches, resumed by the
    port, ends where the JAX package's own run ends."""
    r = runs("metis4")
    (xj, ij), ts = r["jax"], r["ts"]
    x, info = ts.run(max_rounds=400,
                     resume_state=ts.load_checkpoint(r["first"]))
    np.testing.assert_array_equal(info["done_at"], ij["done_at"])
    assert info["total_rounds"] == ij["total_rounds"]
    assert info["rounds"] == ij["rounds"] - 8
    assert float(np.abs(x - xj).max()) <= BAR * float(np.abs(xj).max())


def test_solve_general_slice_matches_jax(monkeypatch):
    """The slice as a whole: solve(free_running=True) on the unstructured
    ani3 matrix with a metis partition takes the general tier in both
    packages (the JAX package's own dispatch test)."""
    built = []
    for mod in (jras, tras):
        def record(*a, _make=mod.make_free_running_solver, **k):
            out = _make(*a, **k)
            built.append(out[0])
            return out
        monkeypatch.setattr(mod, "make_free_running_solver", record)
    A = OPERATORS["ani3"](jmodels, jfem)
    b = jmodels.generate_rhs(A.n, random=False)
    kw = dict(free_running=True, tolerance=1e-3, overlap=2, max_iters=400,
              local_max_iters=24)
    rj = jras.solve(A, b, jcfg.Settings(
        partition=jcfg.Partition.metis,
        comm=jcfg.CommSettings(staleness=1), **kw), num_subdomains=4)
    rt = tras.solve(OPERATORS["ani3"](tmodels, tfem), b, tcfg.Settings(
        partition=tcfg.Partition.metis,
        comm=tcfg.CommSettings(staleness=1), **kw), 4, device="cpu")
    sj, st = built
    assert (type(sj), type(st)) == (JGen, AsyncGeneralRASolver)
    assert rt.converged and rj.converged
    assert (rt.iters, rt.diverged) == (rj.iters, rj.diverged)
    assert rt.relative_residual_norm < 5e-3
    err = float(np.abs(rt.solution - rj.solution).max())
    assert err <= BAR * float(np.abs(rj.solution).max()), err
    # the true residuals differ by at most what the solutions' difference
    # explains
    d = A.to_scipy() @ (np.asarray(rt.solution, np.float64) - rj.solution)
    assert abs(rt.relative_residual_norm - rj.relative_residual_norm) <= (
        np.linalg.norm(d) / np.linalg.norm(b) * (1 + 1e-9) + 1e-15)
    np.testing.assert_allclose(rt.residual_norm / rt.relative_residual_norm,
                               np.linalg.norm(b), rtol=1e-12)
    for f in ("local_resnorm_history", "global_resnorm_history",
              "inner_iters_history", "comm_matrix"):
        a, c = getattr(rj, f), getattr(rt, f)
        assert a.shape == c.shape and np.array_equal(a, c), f


def _problem(n=12, S=4):
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n, random=False)
    return A, b, partition_metis(A, S)


def _rel_err(A, b, x):
    x_ref = spla.spsolve(A.to_scipy().tocsc(), b)
    return np.abs(x - x_ref).max() / np.abs(x_ref).max()


@pytest.mark.parametrize("n,S,tol,kw", [
    (12, 4, 1e-6, {}),
    # on 576 rows the float32 rounds stall near 3e-6: detect at 1e-5
    (24, 6, 1e-5, {}),
    (24, 4, 1e-5, dict(staleness=3)),
    (16, 8, 1e-5, dict(part=None)),      # regular 1-D blocks
])
def test_converges_to_direct_solution(n, S, tol, kw):
    A, b, part = _problem(n, S)
    kw = dict(dict(part=part), **kw)
    s = AsyncGeneralRASolver(A, b, S, overlap=2, tolerance=tol, ninner=12,
                             chunk_rounds=8, device="cpu", **kw)
    x, info = s.run(max_rounds=600)
    assert info["converged"] and len(info["done_at"]) == S
    assert info["relative_residual_norm"] < 5 * tol
    assert _rel_err(A, b, x) < 100 * tol
    assert info["comm_bytes_per_rank"] == info["total_rounds"] * s.plan.C * (
        (s.plan.SEG + 128) * 4 + 12)


def test_staleness_bound_slows_but_converges():
    A, b, part = _problem()
    done = []
    for B in (1, 3):
        s = AsyncGeneralRASolver(A, b, 4, overlap=2, tolerance=1e-6,
                                 staleness=B, ninner=12, chunk_rounds=8,
                                 part=part, device="cpu")
        _, info = s.run(max_rounds=400)
        assert info["converged"]
        done.append(info["done_at"].max())
    assert done[1] > done[0]


def test_oras_converges_not_slower():
    A, b, part = _problem(24, 4)

    def run(c):
        s = AsyncGeneralRASolver(A, b, 4, overlap=2, tolerance=1e-4,
                                 ninner=8, chunk_rounds=8, part=part,
                                 oras_weight=c, device="cpu")
        x, info = s.run(max_rounds=400)
        assert info["converged"] and _rel_err(A, b, x) < 1e-2
        return int(np.max(info["done_at"]))

    assert run(-0.8) <= run(0.0)


def test_nonsym_bicgstab_converges():
    A = tfem.advection_diffusion_2d(16)
    b = np.ones(A.n)
    s = AsyncGeneralRASolver(A, b, 4, overlap=2, tolerance=1e-5, ninner=10,
                             chunk_rounds=8, part=partition_metis(A, 4),
                             nonsym=True, device="cpu")
    x, info = s.run(max_rounds=400)
    assert info["converged"] and _rel_err(A, b, x) < 1e-3


def test_run_refined_reaches_1e8():
    A, b, part = _problem()
    s = AsyncGeneralRASolver(A, b, 4, overlap=2, tolerance=1e-4, ninner=12,
                             chunk_rounds=8, part=part, device="cpu")
    x, info = s.run_refined(tol=1e-8, max_rounds=400)
    assert info["converged"] and info["relative_residual_norm"] <= 1e-8
    assert info["restarts"] >= 2
    r = b - A.to_scipy() @ x
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-8
    # the solver's own rhs and its slots are restored after the restarts
    np.testing.assert_array_equal(s.rhs, b)
    fresh = AsyncGeneralRASolver(A, b, 4, overlap=2, part=part, device="cpu")
    np.testing.assert_array_equal(s.plan.b, fresh.plan.b)
    assert (s._dev["b"] == fresh._dev["b"]).all()
    # two-level refinement: a host coarse correction before each launch
    x, info = s.run_refined(tol=1e-8, coarse_q=4)
    assert info["converged"] and info["relative_residual_norm"] <= 1e-8


def test_checkpoint_resume_matches_straight_run(tmp_path):
    A, b, part = _problem()
    kw = dict(overlap=2, tolerance=1e-6, ninner=12, chunk_rounds=8,
              part=part, device="cpu")
    sol_ref, info_ref = AsyncGeneralRASolver(A, b, 4, **kw).run(
        max_rounds=300)
    assert info_ref["converged"] and info_ref["rounds"] > 16
    ck = str(tmp_path / "frg")
    s1 = AsyncGeneralRASolver(A, b, 4, **kw)
    _, info_cap = s1.run(max_rounds=16, checkpoint_path=ck)
    assert not info_cap["converged"]
    p = s1.plan
    with np.load(ck + ".npz") as f:            # the JAX package's format
        assert [f[k].shape for k in sorted(f.files)] == [
            (4 * p.Rint, 128), (32, 128), (32, 128),
            (4 * p.C * 8 * (p.SEG // 128), 128)]
    s2 = AsyncGeneralRASolver(A, b, 4, **kw)
    sol2, info2 = s2.run(max_rounds=300, resume_state=s2.load_checkpoint(ck))
    # the lockstep schedule is deterministic: resumed == straight run
    np.testing.assert_array_equal(sol_ref, sol2)
    np.testing.assert_array_equal(info_ref["done_at"], info2["done_at"])
    assert info2["total_rounds"] == info_ref["total_rounds"]


def test_rank_count_changes_no_bit():
    """Folding the ranks onto fewer devices changes no bit in the JAX
    package; the port runs one rank per subdomain whatever ``num_ranks``."""
    A, b, part = _problem()
    outs = []
    for D in (None, 1, 2, 4):
        s = AsyncGeneralRASolver(A, b, 4, overlap=2, tolerance=1e-4,
                                 ninner=12, chunk_rounds=8, part=part,
                                 num_ranks=D, device="cpu")
        outs.append(s.run(max_rounds=200))
        assert s.D * s.Sl == 4
    for x, info in outs[1:]:
        np.testing.assert_array_equal(x, outs[0][0])
        np.testing.assert_array_equal(info["done_at"], outs[0][1]["done_at"])


def test_solver_gates():
    A, b, part = _problem()
    with pytest.raises(ValueError, match=r"S \(4\) % devices \(3\)"):
        AsyncGeneralRASolver(A, b, 4, part=part, num_ranks=3, device="cpu")
    with pytest.raises(ValueError, match="partition has 4 parts, expected 5"):
        AsyncGeneralRASolver(A, b, 5, part=part, device="cpu")
    st = tcfg.Settings(free_running=True, tolerance=1e-4,
                       partition=tcfg.Partition.metis,
                       comm=tcfg.CommSettings(fresh_read=True))
    with pytest.raises(NotImplementedFeature, match="fresh_read"):
        tras.make_free_running_solver(A, b, 4, st, device="cpu")
    with pytest.raises(NotImplementedFeature, match="fresh_read"):
        tras.solve(A, b, st, 4, device="cpu")


def test_solver_default_device_needs_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b, part = _problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncGeneralRASolver(A, b, 4, part=part)


@pytest.mark.parametrize("kind", ["metis", "custom", "refused-by-1d"])
def test_dispatch_builds_the_general_tier(kind):
    st = tcfg.Settings(free_running=True, tolerance=1e-3, overlap=2)
    part = None
    if kind == "metis":
        A, S = tmodels.laplacian_2d(16), 4
        st = tcfg.Settings(free_running=True, tolerance=1e-3, overlap=2,
                           partition=tcfg.Partition.metis)
    elif kind == "custom":
        A, S = tmodels.laplacian_2d(16), 4
        part = np.arange(A.n) % S
    else:
        A, S = tfem.laplacian_3d(12), 8     # halo wider than the interior
    solver, refine = tras.make_free_running_solver(
        A, np.ones(A.n), S, st, partition_indices=part, device="cpu")
    assert isinstance(solver, AsyncGeneralRASolver) and not refine
    assert tras.free_running_tier(A, S, st, partition_indices=part) == \
        "general"
    if kind == "metis":
        np.testing.assert_array_equal(
            np.bincount(partition_metis(A, S)), solver.plan.n_int)
    if kind == "custom":
        np.testing.assert_array_equal(solver.plan.int_ids[1],
                                      np.flatnonzero(part == 1))
