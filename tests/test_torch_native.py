"""The port's native setup binding (``schwarz_tpu_torch/native.py`` over
``native/setup_ops.cpp``): partitions and ``Decomposition`` arrays with the
library are bit-identical to the port's numpy path and to the JAX
package's.  The port builds its own copy of the library into
``build/native/``."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu.core.partition import partition_metis as jmetis
from schwarz_tpu_torch import native
from schwarz_tpu_torch.core.partition import partition_metis

jdec = importlib.import_module("schwarz_tpu.core.decompose")
tdec = importlib.import_module("schwarz_tpu_torch.core.decompose")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARRAYS = ("perm", "iperm", "first_row", "interior_count", "interior_offset",
          "rows_count", "ghost_count", "local_to_global", "lmat_cols",
          "lmat_vals", "imat_cols", "imat_vals", "iface_rows", "iface_cols",
          "iface_vals", "local_rhs", "halo_src", "halo_slots",
          "halo_src_halo", "comm_matrix", "global_rhs")


def _assert_same(a, b):
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("row_ptrs", "col_idxs", "values"):
        np.testing.assert_array_equal(getattr(a.global_matrix, f),
                                      getattr(b.global_matrix, f), err_msg=f)


def _without_native(monkeypatch, fn):
    """``fn()`` under ``SCHWARZ_TPU_NATIVE=0``."""
    with monkeypatch.context() as m:
        m.setenv("SCHWARZ_TPU_NATIVE", "0")
        native.reset()
        try:
            assert not native.available()
            return fn()
        finally:
            native.reset()


def test_library_builds_into_build_native():
    assert native.available(), native.reason
    so = native._build()
    assert os.path.dirname(so) == os.path.join(REPO, "build", "native")
    assert os.path.basename(so).startswith("libschwz_setup_")
    # no half-written temporaries left behind
    assert not [f for f in os.listdir(native.BUILD_DIR) if f.endswith(".tmp")]


def test_switch_off_leaves_numpy_path():
    code = ("from schwarz_tpu_torch import native\n"
            "assert not native.available()\n"
            "assert native.reason == 'SCHWARZ_TPU_NATIVE=0', native.reason\n"
            "print('off')\n")
    env = dict(os.environ, SCHWARZ_TPU_NATIVE="0", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "off" in out.stdout


@pytest.mark.parametrize("partition,overlap,dtype", [
    ("regular", 2, "float64"),
    ("regular", 4, "float64"),
    ("metis", 3, "float64"),
    ("regular2d", 3, "float32"),
])
def test_decompose_native_matches_numpy_and_jax(partition, overlap, dtype,
                                                 monkeypatch):
    S = 4
    decs = {}
    for tag, models, cfg, dec in (("jax", jmodels, jcfg, jdec),
                                  ("port", tmodels, tcfg, tdec)):
        A = models.anisotropic_diffusion_2d(12)
        b = models.generate_rhs(A.n)
        s = cfg.Settings(partition=cfg.Partition(partition), overlap=overlap,
                         dtype=dtype)
        decs[tag] = dec.decompose(A, b, s, S)
        if tag == "port":
            decs["numpy"] = _without_native(
                monkeypatch, lambda: dec.decompose(A, b, s, S))
    assert native.available()
    _assert_same(decs["port"], decs["numpy"])
    _assert_same(decs["port"], decs["jax"])


@pytest.mark.parametrize("n,parts", [(48, 6), (30, 16)])
def test_metis_native_matches_python_and_jax(n, parts, monkeypatch):
    """Heavy-edge matching and FM refinement through the library against
    the Python loops, and the JAX package's partition, on one machine."""
    A = tmodels.laplacian_2d(n)
    p_native = partition_metis(A, parts)
    p_python = _without_native(monkeypatch,
                               lambda: partition_metis(A, parts))
    np.testing.assert_array_equal(p_native, p_python)
    np.testing.assert_array_equal(p_native, jmetis(jmodels.laplacian_2d(n),
                                                   parts))


def test_native_kernels_match_numpy_directly():
    """Each entry point against the numpy path on one subdomain."""
    A = tmodels.anisotropic_diffusion_2d(10)
    rp = np.ascontiguousarray(A.row_ptrs, np.int64)
    ci = np.ascontiguousarray(A.col_idxs, np.int64)
    perm = np.random.default_rng(0).permutation(A.n).astype(np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(A.n)
    ip, ix, vv = native.permute_csr(A.n, rp, ci, np.ascontiguousarray(
        A.values, np.float64), perm, iperm)
    dense = A.to_scipy().toarray()[np.ix_(perm, perm)]
    got = np.zeros_like(dense)
    rows = np.repeat(np.arange(A.n), np.diff(ip))
    got[rows, ix] = vv
    np.testing.assert_array_equal(got, dense)
    for r in range(A.n):
        assert np.all(np.diff(ix[ip[r]:ip[r + 1]]) > 0)
    vis = np.zeros(A.n, np.int8)
    clo, gho = native.closure(rp, ci, 20, 40, 2, vis, A.n)
    assert clo[:20].tolist() == list(range(20, 40))
    assert len(set(clo)) == len(clo) and not set(clo) & set(gho)
