"""ctypes binding of the native setup kernels (``native/setup_ops.cpp``): the
port's own copy of ``schwarz_tpu/native.py``.

The host-side setup (BFS closure, ELL split, CSR permutation, and the
heavy-edge matching and FM refinement of the METIS-equivalent partitioner)
has a numpy path in :mod:`schwarz_tpu_torch.core.decompose` and
:mod:`schwarz_tpu_torch.core.partition`, and this C++ fast path, bit-identical
to it.  The library is compiled from the checkout's ``native/setup_ops.cpp``
with ``g++ -O3 -fPIC -shared -std=c++17`` at first use, into
``build/native/`` at the root of the checkout.  Its file name carries a hash
of the source and the flags, so an edited source is rebuilt and a built one
is reused; it is written under a temporary name and renamed into place, so
processes that build at the same moment do not see each other's half-written
file.  ``SCHWARZ_TPU_NATIVE=0``, or a failed build, leaves the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "setup_ops.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# why the last load found no library (None once it loaded)
reason: Optional[str] = None

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> str:
    """Path of the library built from :data:`SOURCE`, compiling it first if
    this source and these flags have not been built yet."""
    cxx = os.environ.get("CXX", "g++")
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libschwz_setup_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load() -> Optional[ctypes.CDLL]:
    """The native library (built at the first call), or None."""
    global _LIB, _TRIED, reason
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SCHWARZ_TPU_NATIVE", "1") == "0":
        reason = "SCHWARZ_TPU_NATIVE=0"
        return None
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", None) or e
        reason = f"native setup library unavailable: {err}"
        return None

    c = ctypes.c_int64
    lib.schwz_closure.argtypes = [
        c, _I64, _I64, c, c, c, _I8, _I64, ctypes.POINTER(c), _I64,
        ctypes.POINTER(c),
    ]
    lib.schwz_closure.restype = ctypes.c_int
    lib.schwz_row_widths.argtypes = [
        _I64, _I64, _I64, _I64, c, c, ctypes.POINTER(c), ctypes.POINTER(c),
    ]
    lib.schwz_row_widths.restype = ctypes.c_int
    lib.schwz_ell_fill.argtypes = [
        _I64, _I64, _F64, _I64, _I64, c, c, c, c, _I32, _F64, _I32, _F64,
    ]
    lib.schwz_ell_fill.restype = ctypes.c_int
    lib.schwz_permute_csr.argtypes = [
        c, _I64, _I64, _F64, _I64, _I64, _I64, _I64, _F64,
    ]
    lib.schwz_permute_csr.restype = ctypes.c_int
    lib.schwz_hem.argtypes = [c, _I64, _I64, _I64, _I64, _I64, _I64]
    lib.schwz_hem.restype = c
    lib.schwz_fm_refine.argtypes = [c, _I64, _I64, _I8, _I64, c, c, c, c]
    lib.schwz_fm_refine.restype = c
    _LIB = lib
    reason = None
    return _LIB


def available() -> bool:
    return load() is not None


def reset() -> None:
    """Forget the last load: the next call loads again and reads
    ``SCHWARZ_TPU_NATIVE`` anew (the built library is reused)."""
    global _LIB, _TRIED, reason
    _LIB, _TRIED, reason = None, False, None


def closure(indptr, indices, first, last, rings, visited_buf, n):
    """Native BFS closure; returns (closure_rows, ghost_rows)."""
    lib = load()
    out_c = np.empty(n, dtype=np.int64)
    out_g = np.empty(n, dtype=np.int64)
    nrows = ctypes.c_int64()
    nghost = ctypes.c_int64()
    rc = lib.schwz_closure(
        n, indptr, indices, int(first), int(last), int(rings),
        visited_buf, out_c, ctypes.byref(nrows), out_g, ctypes.byref(nghost),
    )
    assert rc == 0
    return out_c[: nrows.value].copy(), out_g[: nghost.value].copy()


def row_widths(indptr, indices, g2l, closure_rows, rows_count):
    """(local, interface) ELL widths of one subdomain's rows."""
    lib = load()
    wl = ctypes.c_int64()
    wi = ctypes.c_int64()
    rc = lib.schwz_row_widths(
        indptr, indices, g2l, closure_rows, closure_rows.shape[0],
        int(rows_count), ctypes.byref(wl), ctypes.byref(wi),
    )
    assert rc == 0
    return wl.value, wi.value


def ell_fill(indptr, indices, values, g2l, closure_rows, rows_count,
             lcols, lvals, icols, ivals):
    """Fill pre-allocated (R_rows, W) ELL arrays for one subdomain in place."""
    lib = load()
    Wl = lvals.shape[1] if lvals.size else 0
    Wi = ivals.shape[1] if ivals.size else 0
    rc = lib.schwz_ell_fill(
        indptr, indices, values, g2l, closure_rows, closure_rows.shape[0],
        int(rows_count), Wl, Wi,
        lcols.reshape(-1), lvals.reshape(-1),
        icols.reshape(-1), ivals.reshape(-1),
    )
    assert rc == 0


def heavy_edge_matching(indptr, indices, weights, order):
    """Native HEM coarsening level; returns (coarse_map, n_coarse)."""
    lib = load()
    n = indptr.shape[0] - 1
    matched = np.empty(n, dtype=np.int64)
    coarse_map = np.empty(n, dtype=np.int64)
    nc = lib.schwz_hem(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(weights, np.int64),
        np.ascontiguousarray(order, np.int64),
        matched, coarse_map,
    )
    return coarse_map, int(nc)


def fm_refine(ptr, cols, side_i8, weights, lo, hi, size0, rounds):
    """Native FM refinement rounds (bit-identical to the heapq loop);
    ``side_i8`` is updated in place; returns the final side-0 weight."""
    lib = load()
    n = ptr.shape[0] - 1
    return int(lib.schwz_fm_refine(
        n,
        np.ascontiguousarray(ptr, np.int64),
        np.ascontiguousarray(cols, np.int64),
        side_i8,
        np.ascontiguousarray(weights, np.int64),
        int(lo), int(hi), int(size0), int(rounds),
    ))


def permute_csr(n, indptr, indices, values, perm, iperm):
    """The CSR arrays of P A P^T (rows and columns renumbered, each row's
    columns sorted)."""
    lib = load()
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(indices.shape[0], dtype=np.int64)
    out_values = np.empty(values.shape[0], dtype=np.float64)
    rc = lib.schwz_permute_csr(
        n, indptr, indices, values, perm, iperm,
        out_indptr, out_indices, out_values,
    )
    assert rc == 0
    return out_indptr, out_indices, out_values
