"""The port's local preconditioners against the JAX package's, on the CPU.

The host builds (FSAI(0), ILU(0), the ELL -> DIA conversion, the diagonal
blocks) are numpy in both packages and must agree bit for bit, as must the
preconditioner entries of the solver's plan.  The applies are torch ops
against jax ops (sums in another order): within 1e-12.  Solves through each
preconditioner give the JAX package's iteration count, with histories
within 1e-8 at an outer tolerance of 1e-6 (at 1e-8 the last entries are
rounding noise in either package).
"""

import os

import numpy as np
import pytest
import torch

import schwarz_tpu.config as jcfg
import schwarz_tpu.solvers.precond as jpc
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.solvers.precond as tpc
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import RASolver as TSolver

MATRICES = os.path.join(os.path.dirname(__file__), "..", "matrices")


def _settings(cfg, **kw):
    enums = {"precond": cfg.Precond, "partition": cfg.Partition}
    return cfg.Settings(**{k: enums[k](v) if k in enums else v
                           for k, v in kw.items()})


# the operators: a 2-D Laplacian in strips, the anisotropic FEM matrix, and
# a 2-D partition whose DIA split keeps an ELL remainder
OPERATORS = {
    "lap16": (lambda: tmodels.laplacian_2d(16), dict(overlap=2)),
    "ani3": (lambda: tmodels.read_mtx(os.path.join(MATRICES,
                                                   "ani3_crop.mtx")),
             dict(overlap=2)),
    "lap16_2d": (lambda: tmodels.laplacian_2d(16),
                 dict(overlap=2, partition="regular2d")),
}


def _ell(name, row_pad_multiple=16):
    make, kw = OPERATORS[name]
    A = make()
    b = tmodels.generate_rhs(A.n)
    dec = tdecompose(A, b, _settings(tcfg, row_pad_multiple=row_pad_multiple,
                                     **kw), 4)
    return dec.lmat_vals.astype(np.float64), dec.lmat_cols


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", list(OPERATORS))
def test_fsai_build_bit_for_bit(name):
    vals, cols = _ell(name)
    _equal(tpc.build_fsai(vals, cols), jpc.build_fsai(vals, cols))


@pytest.mark.parametrize("name", list(OPERATORS))
def test_ilu0_build_bit_for_bit(name):
    vals, cols = _ell(name)
    _equal(tpc.build_ilu0(vals, cols), jpc.build_ilu0(vals, cols))


@pytest.mark.parametrize("name", list(OPERATORS))
def test_ell_to_dia_bit_for_bit(name):
    vals, cols = _ell(name)
    glv, glc, guv, guc = tpc.build_fsai(vals, cols)
    lv, lc, uv, uc, _ = tpc.build_ilu0(vals, cols)
    for v, c in ((vals, cols), (glv, glc), (guv, guc), (lv, lc), (uv, uc)):
        to, td = tpc.ell_to_dia(v, c)
        jo, jd = jpc.ell_to_dia(v, c)
        assert to == jo
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("name", list(OPERATORS))
@pytest.mark.parametrize("bs", [4, 16])
def test_diag_blocks_bit_for_bit(name, bs):
    vals, cols = _ell(name)
    got = tpc.extract_diag_blocks(vals, cols, bs)
    want = np.asarray(jpc.extract_diag_blocks(vals, cols, bs))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_diag_blocks_need_a_dividing_block_size():
    vals, cols = _ell("lap16", row_pad_multiple=8)
    with pytest.raises(ValueError, match="must divide"):
        tpc.extract_diag_blocks(vals, cols, 7)


@pytest.mark.parametrize("name", list(OPERATORS))
@pytest.mark.parametrize("kind", ["none", "jacobi", "block_jacobi", "ilu",
                                  "fsai"])
def test_make_preconditioner_matches(name, kind):
    vals, cols = _ell(name)
    r = np.random.default_rng(7).standard_normal(vals.shape[:2])
    mj = jpc.make_preconditioner(
        _settings(jcfg, precond=kind, block_jacobi_block_size=8), vals, cols)
    mt = tpc.make_preconditioner(
        _settings(tcfg, precond=kind, block_jacobi_block_size=8),
        torch.from_numpy(vals), torch.from_numpy(cols.astype(np.int64)))
    if kind == "none":
        assert mj is None and mt is None
        return
    got = mt(torch.from_numpy(r)).numpy()
    want = np.asarray(mj(r))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# the preconditioner entries of the solver's plan, from the same
# decomposition: bit for bit (the O-RAS and mixed-precision forms build
# from the Robin-modified operator and store in the inner dtype)
PLAN_CASES = {
    "fsai-dia": ("lap16", dict(precond="fsai", spmv_format="dia",
                               row_pad_multiple=128)),
    "fsai-dia-remainder": ("lap16_2d", dict(precond="fsai",
                                            spmv_format="dia",
                                            row_pad_multiple=128)),
    "fsai-ell": ("ani3", dict(precond="fsai")),
    "ilu-dia": ("lap16", dict(precond="ilu", spmv_format="dia")),
    "ilu-ell": ("ani3", dict(precond="ilu")),
    "block-jacobi": ("lap16_2d", dict(precond="block_jacobi",
                                      row_pad_multiple=16)),
    "jacobi-oras": ("lap16", dict(precond="jacobi", oras_weight=-0.8)),
    "fsai-oras-f32": ("lap16", dict(precond="fsai", spmv_format="dia",
                                    oras_weight="auto",
                                    local_compute_dtype="float32")),
    "block-jacobi-f32": ("ani3", dict(precond="block_jacobi",
                                      block_jacobi_block_size=4,
                                      dtype="float32")),
}
PLAN_KEYS = ("precond_dinv", "precond_blockinv", "ilu_udinv", "ilu_l_dia",
             "ilu_u_dia", "ilu_l_vals", "ilu_l_cols", "ilu_u_vals",
             "ilu_u_cols", "fsai_gl_dia", "fsai_gu_dia", "fsai_gl_vals",
             "fsai_gl_cols", "fsai_gu_vals", "fsai_gu_cols")


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_entries_bit_for_bit(case):
    name, kw = PLAN_CASES[case]
    make, okw = OPERATORS[name]
    A = make()
    b = tmodels.generate_rhs(A.n)
    kw = {**okw, **kw}
    js = JSolver(jdecompose(A, b, _settings(jcfg, **kw), 4))
    ts = TSolver(tdecompose(A, b, _settings(tcfg, **kw), 4), device="cpu")
    keys = [k for k in PLAN_KEYS if k in js._plan]
    assert keys and keys == [k for k in PLAN_KEYS if k in ts._plan]
    for k in keys:
        want = np.asarray(js._plan[k])
        got = ts._plan[k].numpy()
        if k.endswith("_cols"):
            want, got = want.astype(np.int64), got.astype(np.int64)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for attr in ("fsai_offsets", "ilu_offsets"):
        assert getattr(ts._local, attr) == getattr(js, "_" + attr, None)


# solves through each preconditioner: the configurations of
# tests/test_fsai.py, tests/test_ilu.py and tests/test_local_solvers.py
SOLVE_CASES = {
    "fsai-dia": (16, dict(overlap=2, spmv_format="dia", row_pad_multiple=128,
                          precond="fsai")),
    "fsai-capped": (32, dict(overlap=3, precond="fsai", local_max_iters=8,
                             local_tolerance=1e-10)),
    "fsai-dia-remainder": (16, dict(overlap=2, partition="regular2d",
                                    spmv_format="dia", row_pad_multiple=128,
                                    precond="fsai", local_max_iters=8,
                                    local_tolerance=1e-10)),
    "ilu": (24, dict(overlap=3, precond="ilu", ilu_sweeps=3)),
    "ilu-dia": (24, dict(overlap=3, precond="ilu", spmv_format="dia")),
    "block-jacobi": (24, dict(overlap=3, precond="block_jacobi",
                              block_jacobi_block_size=8)),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_through_preconditioner_matches(case):
    n, kw = SOLVE_CASES[case]
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n)
    kw = dict(kw, tolerance=1e-6, max_iters=400)
    rj = JSolver(jdecompose(A, b, _settings(jcfg, **kw), 4)).run()
    rt = TSolver(tdecompose(A, b, _settings(tcfg, **kw), 4),
                 device="cpu").run()
    assert rj.converged and rt.iters == rj.iters
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=1e-8)
    # an inner CG that hovers at its stopping threshold for a few
    # iterations may stop a few later or earlier (block-Jacobi: 3)
    assert np.abs(rt.inner_iters_history.astype(int)
                  - rj.inner_iters_history).max() <= 3
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=1e-8,
                               atol=1e-12)
