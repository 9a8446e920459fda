"""The plain PyTorch versions of the port's kernels (K1 DIA SpMV, K2 x_ext
assembly, K3 fused CG) against the JAX package's Pallas kernels, run in interpret
mode on the CPU as the JAX package's own tests run them, and against its XLA
paths.  On CPU tensors each kernel wrapper takes its plain version; the
kernels themselves are held to these versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schwarz_tpu import Settings as JSettings
from schwarz_tpu import generate_rhs, laplacian_2d, read_mtx
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.models import matrix_path
from schwarz_tpu.ops.dia import dia_ell_spmv as j_dia_ell_spmv
from schwarz_tpu.ops.dia import dia_spmv as j_dia_spmv
from schwarz_tpu.ops.dia import split_dia_ell
from schwarz_tpu.ops.fused_cg import fused_cg_solve as j_fused_cg
from schwarz_tpu.ops.halo_pallas import (
    assemble_runs_fused,
    build_tiled_plan,
    window_insert_xla,
)
from schwarz_tpu.ops.pallas_kernels import (
    dia_spmv_pallas,
    dia_spmv_pallas2d,
    dia_spmv_pallas3,
)
from schwarz_tpu.parallel.exchange import assemble_x_ext
from schwarz_tpu.parallel.exchange import assemble_x_ext_runs as j_runs
from schwarz_tpu.parallel.exchange import build_run_plan
from schwarz_tpu_torch.ops.dia import dia_ell_spmv as t_dia_ell_spmv
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv, dia_spmv_plain
from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve, fused_cg_solve_plain
from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext as k2
from schwarz_tpu_torch.parallel.exchange import (
    exchange_halo_allgather,
    segments_of,
)
from schwarz_tpu_torch.ras import plan_from_numpy


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K1 ------
@pytest.mark.parametrize("kern", [dia_spmv_pallas, dia_spmv_pallas2d,
                                  dia_spmv_pallas3],
                         ids=["pallas", "pallas2d", "pallas3"])
@pytest.mark.parametrize("offsets", [(-128, -1, 0, 1, 128), (-48, 0, 48)])
def test_k1_plain_matches_pallas(kern, offsets):
    """rtol 1e-6: float32 sums of K positive terms in another order."""
    rng = np.random.default_rng(11)
    S, R = 3, 512
    M = max(abs(o) for o in offsets)
    dia = rng.random((S, len(offsets), R)).astype(np.float32)
    x = rng.random((S, R)).astype(np.float32)
    y_j = np.asarray(kern(offsets, jnp.asarray(dia),
                          jnp.asarray(np.pad(x, ((0, 0), (M, M)))),
                          interpret=True))
    n0 = dia_spmv.launches
    y_t = dia_spmv(offsets, _t(dia), _t(x)).numpy()
    assert dia_spmv.launches == n0      # CPU tensors take the plain version
    np.testing.assert_allclose(y_t, y_j, rtol=1e-6)


def _decomp(kind, S, overlap, dtype, pad=8):
    A = (laplacian_2d(int(kind[3:])) if kind.startswith("lap")
         else read_mtx(matrix_path(f"{kind}_crop.mtx")))
    b = generate_rhs(A.n)
    return jdecompose(A, b, JSettings(overlap=overlap, dtype=dtype,
                                      row_pad_multiple=pad), S)


@pytest.mark.parametrize("kind,S", [("lap32", 4), ("ani4", 4)])
def test_k1_plain_matches_xla_f64(kind, S):
    """float64 within 1e-12 of dia_spmv and of dia_ell_spmv (the XLA path);
    x is wider than R, as x_ext is, and read only in [0, R)."""
    dec = _decomp(kind, S, 3, "float64")
    hyb = split_dia_ell(dec.lmat_vals, dec.lmat_cols, dec.rows_count)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((S, dec.meta.max_ext))
    y_j = np.asarray(j_dia_spmv(hyb.offsets, jnp.asarray(hyb.dia_vals),
                                jnp.asarray(x)))
    y_t = dia_spmv(hyb.offsets, _t(hyb.dia_vals), _t(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-12)
    plan = plan_from_numpy({
        "dia": hyb.dia_vals, "rr": hyb.rem_rows.astype(np.int64),
        "rv": hyb.rem_vals, "rc": hyb.rem_cols.astype(np.int64), "x": x},
        "cpu")
    z_j = np.asarray(j_dia_ell_spmv(
        hyb.offsets, jnp.asarray(hyb.dia_vals), jnp.asarray(hyb.rem_rows),
        jnp.asarray(hyb.rem_vals), jnp.asarray(hyb.rem_cols),
        jnp.asarray(x)))
    z_t = t_dia_ell_spmv(hyb.offsets, plan["dia"], plan["rr"], plan["rv"],
                         plan["rc"], plan["x"]).numpy()
    np.testing.assert_allclose(z_t, z_j, rtol=1e-12, atol=1e-12)
    if not np.count_nonzero(hyb.rem_vals):
        z0 = t_dia_ell_spmv(hyb.offsets, plan["dia"], plan["rr"], plan["rv"],
                            plan["rc"], plan["x"], has_remainder=False)
        np.testing.assert_array_equal(z0.numpy(), z_t)


def test_k1_plain_on_strided_view():
    """The solver passes x_ext[:, :R_rows], a view with a longer row."""
    rng = np.random.default_rng(4)
    offsets = (-7, 0, 3)
    dia = _t(rng.standard_normal((2, 3, 40)))
    x = _t(rng.standard_normal((2, 64)))
    np.testing.assert_array_equal(dia_spmv(offsets, dia, x[:, :45]).numpy(),
                                  dia_spmv_plain(offsets, dia,
                                                 x.contiguous()).numpy())


# ---------------------------------------------------------------- K2 ------
@pytest.mark.parametrize("n1d,S,overlap", [(128, 4, 2), (128, 8, 3)])
def test_k2_plain_bit_identical_to_fused_and_runs(n1d, S, overlap):
    dec = _decomp(f"lap{n1d}", S, overlap, "float32", pad=128)
    r_ext, r_int = dec.meta.max_ext, dec.meta.max_interior
    rp = build_run_plan(dec.halo_src_halo, dec.halo_slots, r_ext, r_int,
                        dec.interior_offset)
    tp = build_tiled_plan(rp, dec.interior_offset, r_int, r_ext, S, tile=128)
    assert tp is not None
    rng = np.random.default_rng(5)
    x_own = rng.standard_normal((S, r_int)).astype(np.float32)
    off = dec.interior_offset.astype(np.int32)
    # JAX: the XLA window insert, then the DMA kernel (interpret, tile=128)
    win = window_insert_xla(jnp.asarray(x_own), jnp.asarray(off),
                            tp.uniq_offs, r_ext)
    fused = np.asarray(assemble_runs_fused(
        win, jnp.asarray(x_own.reshape(-1)),
        tuple(jnp.asarray(t) for t in tp.src_t),
        tuple(jnp.asarray(t) for t in tp.dst_t),
        tp.lengths_t, tp.r_ext_t, tile=128, interpret=True))
    runs = np.asarray(j_runs(
        jnp.asarray(x_own), jnp.asarray(x_own.reshape(-1)),
        jnp.asarray(off), rp.lengths,
        tuple(jnp.asarray(t) for t in rp.run_src),
        tuple(jnp.asarray(t) for t in rp.run_dst), r_ext, jnp.float32))
    tables = plan_from_numpy(dict(zip(("segs", "first"),
                                      segments_of(dec))), "cpu")
    n0 = k2.launches
    got = exchange_halo_allgather(
        _t(x_own), (tables["segs"], tables["first"]), r_ext).numpy()
    assert k2.launches == n0
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, runs)


@pytest.mark.parametrize("kind,S,overlap,dtype", [
    ("lap12", 4, 3, "float64"), ("lap32", 4, 2, "float64"),
    ("ani4", 4, 2, "float64"), ("ani3", 2, 3, "float32")])
def test_k2_plain_bit_identical_to_xla_paths(kind, S, overlap, dtype):
    """Both halo forms (read from the gathered interiors, and from
    compact halo values) give the XLA gather path's x_ext bit for bit."""
    dec = _decomp(kind, S, overlap, dtype)
    r_ext, r_int = dec.meta.max_ext, dec.meta.max_interior
    rng = np.random.default_rng(6)
    x_own = rng.standard_normal((S, r_int)).astype(dtype)
    off = dec.interior_offset.astype(np.int32)
    x_all = jnp.asarray(x_own.reshape(-1))
    ref = np.asarray(assemble_x_ext(
        jnp.asarray(x_own), jnp.asarray(off), jnp.asarray(dec.halo_slots),
        x_all[jnp.asarray(dec.halo_src_halo)], r_ext))
    got = exchange_halo_allgather(
        _t(x_own), tuple(map(_t, segments_of(dec))), r_ext).numpy()
    np.testing.assert_array_equal(got, ref)
    halo = _t(x_own.reshape(-1)[dec.halo_src_halo])
    got = k2(_t(x_own), halo, *map(_t, segments_of(dec, compact=True)),
             r_ext).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- K3 ------
def _pure_dia(n=24, S=4, overlap=2):
    dec = _decomp(f"lap{n}", S, overlap, "float32", pad=128)
    hyb = split_dia_ell(dec.lmat_vals, dec.lmat_cols, dec.rows_count,
                        max_diags=40, min_fill=0.0)
    assert not np.count_nonzero(hyb.rem_vals)
    return dec, hyb


@pytest.mark.parametrize("jacobi", [False, True])
def test_k3_plain_matches_fused_interpret(jacobi):
    """iters within +-1 and x within atol 5e-4: the same float32 CG with
    sums in another order; subdomain 3 starts at its solution (b = 0) and
    must not iterate."""
    dec, hyb = _pure_dia()
    S, _, R = hyb.dia_vals.shape
    rng = np.random.default_rng(7)
    b = (rng.standard_normal((S, R)) * dec.masks()[0]).astype(np.float32)
    b[3] = 0.0
    x0 = np.zeros((S, R), np.float32)
    d = hyb.dia_vals[:, hyb.offsets.index(0), :]
    dinv = (np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
            .astype(np.float32) if jacobi else None)
    ref = j_fused_cg(hyb.offsets, jnp.asarray(hyb.dia_vals), jnp.asarray(b),
                     jnp.asarray(x0),
                     None if dinv is None else jnp.asarray(dinv), 1e-6,
                     jnp.int32(200), has_dinv=jacobi, interpret=True)
    n0 = fused_cg_solve.launches
    got = fused_cg_solve(hyb.offsets, _t(hyb.dia_vals), _t(b), _t(x0),
                         None if dinv is None else _t(dinv), 1e-6, 200)
    assert fused_cg_solve.launches == n0
    assert int(got.iters[3]) == 0 and int(ref.iters[3]) == 0
    assert np.abs(got.iters.numpy() - np.asarray(ref.iters)).max() <= 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=5e-4)
    assert np.all(got.rel_resnorm.numpy()[:3] <= 1e-6 + 1e-8)


def test_k3_plain_warm_start_and_budget():
    dec, hyb = _pure_dia()
    S, _, R = hyb.dia_vals.shape
    rng = np.random.default_rng(8)
    mask = dec.masks()[0]
    b = (rng.standard_normal((S, R)) * mask).astype(np.float32)
    x0 = (rng.standard_normal((S, R)) * mask * 0.1).astype(np.float32)
    args = (hyb.offsets, _t(hyb.dia_vals), _t(b), _t(x0), None)
    ref = j_fused_cg(hyb.offsets, jnp.asarray(hyb.dia_vals), jnp.asarray(b),
                     jnp.asarray(x0), None, 1e-12, jnp.int32(3),
                     interpret=True)
    got = fused_cg_solve_plain(*args, 1e-12, 3)
    assert int(got.iters.max()) == 3 == int(ref.iters.max())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=5e-4)
