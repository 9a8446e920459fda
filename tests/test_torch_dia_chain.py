"""K1's chained product, ``DIA_out @ (DIA_in @ x)``, against the JAX
package's FSAI apply on the CPU.

The JAX solver applies FSAI(0) on a DIA operator as ``dia_spmv(uo, ud,
dia_spmv(go, gd, r))`` (``schwarz_tpu/ras.py`` apply_fsai_dia, through
``schwarz_tpu/ops/dia.py``); its Pallas K1 (``dia_spmv_pallas3``, run in
interpret mode) computes each product too.  The port runs the pair as one
launch of :func:`dia_spmv_chain` on the card, and its plain version
:func:`dia_spmv_chain_plain` (two plain products) on CPU tensors.  The FSAI
factors come from each package's own build on the same decomposition.
float32 within rtol 1e-6 and float64 within 1e-12: the same products summed
in another order (the bar of tests/test_torch_kernels.py's K1 cases).  The
chain reads the inner product as zero outside ``[0, R)``, as the second of
two products does; offsets that reach past both ends check it against dense
matrices.  The kernel itself is held to this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 3 and 21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarz_tpu.solvers.precond as jpc
from schwarz_tpu import Settings as JSettings
from schwarz_tpu import generate_rhs, laplacian_2d
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.ops.dia import dia_spmv as j_dia_spmv
from schwarz_tpu.ops.pallas_kernels import dia_spmv_pallas3
import schwarz_tpu_torch.solvers.precond as tpc
from schwarz_tpu_torch import Settings as TSettings
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.models import laplacian_2d as t_laplacian_2d
from schwarz_tpu_torch.ops import dia_kernel
from schwarz_tpu_torch.ops.dia_kernel import (dia_spmv,
                                              dia_spmv_chain,
                                              dia_spmv_chain_plain,
                                              dia_spmv_plain, window_fits)

TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "float64": dict(rtol=1e-12, atol=1e-12)}


def _fsai_dia(pkg, n1d, S=4):
    """(go, gd, uo, ud): the FSAI(0) factors of laplacian_2d(n1d) in S
    strips (overlap 2, rows padded to 128), built by ``pkg`` on its own
    decomposition, as the solver builds them on the DIA operator."""
    if pkg == "jax":
        A = laplacian_2d(n1d)
        dec = jdecompose(A, generate_rhs(A.n), JSettings(
            overlap=2, row_pad_multiple=128), S)
        build, to_dia = jpc.build_fsai, jpc.ell_to_dia
    else:
        A = t_laplacian_2d(n1d)
        dec = tdecompose(A, generate_rhs(A.n), TSettings(
            overlap=2, row_pad_multiple=128), S)
        build, to_dia = tpc.build_fsai, tpc.ell_to_dia
    glv, glc, guv, guc = build(np.asarray(dec.lmat_vals, np.float64),
                               np.asarray(dec.lmat_cols))
    go, gd = to_dia(glv, glc)
    uo, ud = to_dia(guv, guc)
    return go, gd, uo, ud


def _j_pallas(offsets, dia, x):
    M = max(abs(o) for o in offsets)
    return dia_spmv_pallas3(offsets, dia, jnp.pad(x, ((0, 0), (M, M))),
                            interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n1d", [16, 32])
def test_chain_plain_matches_jax_fsai_apply(n1d, dtype):
    go, gd, uo, ud = _fsai_dia("torch", n1d)
    jgo, jgd, juo, jud = _fsai_dia("jax", n1d)
    assert (go, uo) == (jgo, juo)
    np.testing.assert_array_equal(gd, jgd)
    np.testing.assert_array_equal(ud, jud)
    gd, ud = gd.astype(dtype), ud.astype(dtype)
    S, _, R = gd.shape
    r = np.random.default_rng(n1d).standard_normal((S, R)).astype(dtype)
    t = [torch.from_numpy(a) for a in (gd, ud, r)]
    got = dia_spmv_chain_plain(go, t[0], uo, t[1], t[2]).numpy()
    want = np.asarray(j_dia_spmv(uo, jnp.asarray(ud),
                                 j_dia_spmv(go, jnp.asarray(gd),
                                            jnp.asarray(r))))
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "float32":          # the Pallas K1 takes float32 only
        p = np.asarray(_j_pallas(uo, jnp.asarray(ud),
                                 _j_pallas(go, jnp.asarray(gd),
                                           jnp.asarray(r))))
        np.testing.assert_allclose(got, p, **TOL[dtype])
    # the wrapper on CPU tensors is its plain version, and counts nothing
    n0, by0 = dia_spmv.launches, dict(dia_spmv.launches_by)
    np.testing.assert_array_equal(
        dia_spmv_chain(go, t[0], uo, t[1], t[2]).numpy(), got)
    assert dia_spmv.launches == n0 and dia_spmv.launches_by == by0


def _dense(offsets, dia):
    """(S, R, R) dense matrices of a DIA block; entries whose column falls
    outside [0, R) are dropped."""
    S, K, R = dia.shape
    out = np.zeros((S, R, R), dia.dtype)
    rows = np.arange(R)
    for k, o in enumerate(offsets):
        c = rows + o
        ok = (c >= 0) & (c < R)
        out[:, rows[ok], c[ok]] = dia[:, k, ok]
    return out


# one-sided offsets reaching past both ends of [0, R), R = 40: the inner
# product's rows outside [0, R) are never formed, so they read as zero
REACH = [
    ((-70, -3, 0), (0, 5, 90)),
    ((0, 2, 45), (-45, -1)),
    ((-39, 39), (-50, 0, 50)),
    ((41,), (-41,)),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offs", REACH, ids=lambda o: f"{o[0]}-{o[1]}")
def test_chain_plain_zero_outside(offs, dtype):
    oi, oo = offs
    rng = np.random.default_rng(len(oi) + 10 * len(oo))
    S, R = 3, 40
    di = rng.standard_normal((S, len(oi), R)).astype(dtype)
    do = rng.standard_normal((S, len(oo), R)).astype(dtype)
    x = rng.standard_normal((S, R + 9)).astype(dtype)   # wider than R
    got = dia_spmv_chain_plain(oi, torch.from_numpy(di), oo,
                               torch.from_numpy(do),
                               torch.from_numpy(x)[:, 2:2 + R + 5]).numpy()
    xs = x[:, 2:2 + R].astype(np.float64)
    want = np.einsum("sij,sj->si", _dense(oo, do.astype(np.float64)),
                     np.einsum("sij,sj->si", _dense(oi, di.astype(np.float64)),
                               xs))
    np.testing.assert_allclose(got, want, rtol=1e-5 if dtype == "float32"
                               else 1e-12, atol=1e-5 if dtype == "float32"
                               else 1e-12)
    jx = jnp.asarray(x[:, 2:2 + R])
    jw = np.asarray(j_dia_spmv(oo, jnp.asarray(do),
                               j_dia_spmv(oi, jnp.asarray(di), jx)))
    np.testing.assert_allclose(got, jw, **TOL[dtype])


def test_chain_plain_is_two_plain_products():
    """Bit for bit: the plain chain is the two products the solver ran."""
    rng = np.random.default_rng(5)
    go, uo = (-16, -1, 0), (0, 1, 16)
    gd, ud = (torch.from_numpy(rng.standard_normal((2, 3, 64)))
              for _ in range(2))
    r = torch.from_numpy(rng.standard_normal((2, 64)))
    assert torch.equal(dia_spmv_chain_plain(go, gd, uo, ud, r),
                       dia_spmv_plain(uo, ud, dia_spmv_plain(go, gd, r)))


@pytest.mark.parametrize("dtype,offsets,tile,fits", [
    (torch.float32, (0, 1, 512), 1344, True),     # the flagship's G^T
    (torch.float64, (0, 1, 512), 2048, True),
    (torch.float32, (-5000, 0, 5000), 2048, True),   # 48 192 bytes ...
    (torch.float64, (-5000, 0, 5000), 256, False),   # ... 82 048
    (torch.float32, (0, 20000), 256, False),
])
def test_chain_window_fits(dtype, offsets, tile, fits):
    """The chain runs as one launch while a tile's window (its rows and the
    span of the outer offsets) fits 48 KB of shared memory, else as two
    single launches (``csrc/dia_spmv.cu`` launch_chain)."""
    assert window_fits(offsets, dtype, tile) is fits


@pytest.mark.parametrize("S,R,tile", [
    (16, 21504, 1344),     # the flagship: 16 tiles a subdomain, 256 blocks
    (16, 23552, 1472),     # the campaign's rows
    (64, 4992, 1248),      # the direct phase's 64 subdomains, 4 tiles each
    (3, 1000, 256),        # at least 256 rows
    (1, 2000000, 2048),    # at most MAX_TILE
])
def test_chain_default_tile(monkeypatch, S, R, tile):
    """About two blocks per SM of an H100 (132 SMs) over the subdomains,
    in whole multiples of 32 rows from 256 to 2048."""
    monkeypatch.setitem(dia_kernel._sm_counts, 0, 132)
    assert dia_kernel.default_tile(S, R, torch.device("cuda", 0)) == tile
