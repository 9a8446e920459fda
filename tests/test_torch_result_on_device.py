"""A solve's fixed cost on the device, on the CPU: ``set_rhs``'s gathers,
``run_accelerated``'s ``b_own`` and the result (the solution's permutation
and the float64 true residual against the global CSR operator) held to
the host formulas they replace, computed here from the decomposition with
NumPy and SciPy.

A METIS partition, so the permutation is not the identity, with rows padded
to 8, in float64 and float32 settings, through ``run``,
``run_instrumented`` and ``run_accelerated``: the solution bit for bit,
the norms within 1e-12 relative, no SciPy conversion after set-up, and
the reads at site ``result`` pinned.  A 17^2 Laplacian on 4 subdomains:
seconds in all."""

import numpy as np
import pytest
import torch

import schwarz_tpu_torch.config as cfg
import schwarz_tpu_torch.models as models
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.models.csr import CSRMatrix
from schwarz_tpu_torch.ras import RASolver
from schwarz_tpu_torch.utils import timing

ENTRIES = ("run", "run_instrumented", "run_accelerated")
DTYPES = ("float64", "float32")
N_SIDE, S = 17, 4


def _settings(entry, dtype):
    kw = dict(partition=cfg.Partition.metis, overlap=2, row_pad_multiple=8,
              dtype=dtype, tolerance=1e-6 if dtype == "float64" else 1e-4,
              max_iters=200)
    if entry == "run_accelerated":
        kw.update(local_solver=cfg.LocalSolver.direct_cholesky,
                  accelerator="fgmres", restart_iter=10)
    return cfg.Settings(**kw)


def _build(entry, dtype):
    A = models.laplacian_2d(N_SIDE)
    dec = decompose(A, models.generate_rhs(A.n), _settings(entry, dtype), S)
    solver = RASolver(dec, device="cpu")
    # the iterate each result is assembled from
    seen = []
    assemble = solver._assemble_result

    def spy(x_own, *args, **kwargs):
        seen.append(x_own.clone())
        return assemble(x_own, *args, **kwargs)

    solver._assemble_result = spy
    return A, dec, solver, seen


def _rhs(n_rows, k):
    return np.random.default_rng(k).uniform(-1.0, 2.0, n_rows)


def _host_formula(dec, A_p, rhs, x_own):
    """The solution and the true residual's norms as the host assembled
    them: the interiors in permuted order, scattered back through
    ``perm``, and ``b - A x`` in float64 with SciPy against the permuted
    matrix ``A_p``."""
    x_own = x_own.numpy()
    x_perm = np.zeros(dec.meta.global_size, dtype=x_own.dtype)
    for p in range(dec.meta.num_subdomains):
        lo, hi = dec.first_row[p], dec.first_row[p + 1]
        x_perm[lo:hi] = x_own[p, :hi - lo]
    x_orig = np.zeros_like(x_perm)
    x_orig[dec.perm] = x_perm
    b = rhs.astype(np.float64)[dec.perm].astype(dec.global_rhs.dtype)
    b = b.astype(np.float64)
    resid = b - A_p @ x_perm.astype(np.float64)
    return x_orig, float(np.linalg.norm(resid)), float(np.linalg.norm(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_result_equals_the_host_formula(entry, dtype):
    A, dec, solver, seen = _build(entry, dtype)
    assert not np.array_equal(dec.perm, np.arange(A.n))
    assert dec.meta.max_rows > dec.rows_count.min()
    A_sp = dec.global_matrix.to_scipy()
    for k in (1, 2):
        rhs = _rhs(A.n, k)
        solver.set_rhs(rhs)
        res = getattr(solver, entry)()
        assert res.iters > 0
        x, rn, bn = _host_formula(dec, A_sp, rhs, seen[-1])
        assert res.solution.dtype == x.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(res.solution, x)
        assert res.residual_norm == pytest.approx(rn, rel=1e-12)
        assert res.relative_residual_norm == pytest.approx(rn / bn,
                                                           rel=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_a_solve_converts_nothing_and_reads_once(entry, dtype, monkeypatch):
    A, _, solver, _ = _build(entry, dtype)

    def refuse(self):
        raise AssertionError("to_scipy called after set-up")

    monkeypatch.setattr(CSRMatrix, "to_scipy", refuse)
    before = timing.counts().get(timing.HOST_READS, {}).get("result", 0)
    solver.set_rhs(_rhs(A.n, 3))
    res = getattr(solver, entry)()
    after = timing.counts()[timing.HOST_READS]["result"]
    assert np.isfinite(res.relative_residual_norm)
    assert after - before == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_set_rhs_gathers_equal_the_host_loops(dtype):
    """``local_rhs`` and ``b_own`` gathered on the device equal the host
    loops they replace, padding slots zero; the decomposition keeps the
    rhs it was built with."""
    A, dec, solver, _ = _build("run_accelerated", dtype)
    kept = dec.global_rhs.copy(), dec.local_rhs.copy()
    rhs = _rhs(A.n, 4)
    solver.set_rhs(rhs)
    np_dtype = np.dtype(dtype)
    rhs_p = rhs.astype(np.float64)[dec.perm]
    local = np.zeros(dec.local_rhs.shape, np_dtype)
    b_own = np.zeros((S, dec.meta.max_interior), np_dtype)
    for p in range(S):
        rc = int(dec.rows_count[p])
        local[p, :rc] = rhs_p[dec.local_to_global[p, :rc]]
        lo, hi = dec.first_row[p], dec.first_row[p + 1]
        b_own[p, :hi - lo] = rhs_p[lo:hi]
    np.testing.assert_array_equal(solver._plan["local_rhs"].numpy(), local)
    g = solver._io["global_rhs"]
    np.testing.assert_array_equal(g[:-1].numpy(), rhs_p.astype(np_dtype))
    assert g[-1] == 0
    np.testing.assert_array_equal(g[solver._io["b_own"]].numpy(), b_own)
    np.testing.assert_array_equal(dec.global_rhs, kept[0])
    np.testing.assert_array_equal(dec.local_rhs, kept[1])


def test_global_operator_is_the_permuted_matrix():
    """The residual's CSR operator holds the decomposition's permuted
    matrix in float64, and its product is SciPy's within the summation's
    rounding bound (the CPU build may sum a row in another order)."""
    A, dec, solver, _ = _build("run", "float64")
    M = solver._io["global_matrix"]
    assert M.dtype == torch.float64
    A_p = dec.global_matrix.to_scipy()
    np.testing.assert_array_equal(M.to_dense().numpy(), A_p.toarray())
    x = np.random.default_rng(5).standard_normal(A.n)
    y = torch.mv(M, torch.from_numpy(x)).numpy()
    bound = 8 * np.finfo(np.float64).eps * (abs(A_p) @ np.abs(x))
    assert np.all(np.abs(y - A_p @ x) <= bound)


@pytest.mark.parametrize("split", [False, True])
def test_set_rhs_writes_in_place(split):
    """Two ``set_rhs`` calls with different right-hand sides keep the
    storage of ``local_rhs``, the permuted global rhs and, under
    ``overlap_split``, ``z_base`` (a captured step reads them by address),
    and leave in them the host formula's values for the latest rhs."""
    kw = dict(partition=cfg.Partition.metis, overlap=2, row_pad_multiple=8,
              tolerance=1e-6, max_iters=200)
    if split:
        kw.update(local_solver=cfg.LocalSolver.direct_cholesky,
                  direct_apply="inverse",
                  comm=cfg.CommSettings(overlap_split=True))
    A = models.laplacian_2d(N_SIDE)
    dec = decompose(A, models.generate_rhs(A.n), cfg.Settings(**kw), S)
    solver = RASolver(dec, device="cpu")
    plan, io = solver._plan, solver._io
    keys = ["local_rhs"] + (["z_base"] if split else [])
    ptrs = [plan[k].data_ptr() for k in keys] + [io["global_rhs"].data_ptr()]
    for k in (5, 6):
        rhs = _rhs(A.n, k)
        solver.set_rhs(rhs)
        assert [plan[k].data_ptr() for k in keys] + [
            io["global_rhs"].data_ptr()] == ptrs
        rhs_p = rhs[dec.perm]
        local = np.zeros(dec.local_rhs.shape)
        for p in range(S):
            rc = int(dec.rows_count[p])
            local[p, :rc] = rhs_p[dec.local_to_global[p, :rc]]
        np.testing.assert_array_equal(plan["local_rhs"].numpy(), local)
        np.testing.assert_array_equal(io["global_rhs"][:-1].numpy(), rhs_p)
        if split:
            want = solver._local.z_base(torch.from_numpy(local))
            np.testing.assert_array_equal(plan["z_base"].numpy(),
                                          want.numpy())
