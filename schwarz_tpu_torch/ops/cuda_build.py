"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/torch_kernels/`` at the
root of the checkout, at first use.  The library's file name carries a hash
of its sources and flags, so an edited source is rebuilt and a built one is
reused.  Libraries load through ``ctypes``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from schwarz_tpu_torch.utils.timing import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
KERNEL_SOURCES = ("dia_spmv", "halo_runs", "fused_cg", "async_ras",
                  "async_ras_2d", "async_ras_general", "diagnostics",
                  "rdma_shift", "peer_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# K5, K6 and K7 round a*b+c twice, as PyTorch's separate operations do, so
# that the card and the plain versions agree bit for bit (csrc/async_ras.cu,
# csrc/async_ras_2d.cu, csrc/async_ras_general.cu)
EXTRA_FLAGS = {"async_ras": ("-fmad=false",),
               "async_ras_2d": ("-fmad=false",),
               "async_ras_general": ("-fmad=false",)}

_libs: dict = {}

# C signatures: pointers, the stream and 64-bit strides as void*/longlong,
# so ctypes never truncates them to 32-bit ints
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ULL = ctypes.c_ulonglong
SIGNATURES = {
    "dia_spmv": {
        "dia_spmv_f32": (_P, _P, _P, _I, _I, _I, _LL, _P, _P),
        "dia_spmv_f64": (_P, _P, _P, _I, _I, _I, _LL, _P, _P),
        "dia_spmv_chain_f32": (_P,) * 4 + (_I,) * 4 + (_LL, _P, _P, _I, _P),
        "dia_spmv_chain_f64": (_P,) * 4 + (_I,) * 4 + (_LL, _P, _P, _I, _P),
    },
    "halo_runs": {
        "halo_assemble_f32": (_P,) * 5 + (_I,) * 5 + (_P,),
        "halo_assemble_f64": (_P,) * 5 + (_I,) * 5 + (_P,),
    },
    "fused_cg": {
        "fused_cg_max_clusters": (_I, _I, _I, _I),
        "fused_cg_f32": (_P,) * 13 + (_I,) * 5 + (_P,) * 3
        + (_F, _I, _I, _I, _I, _P),
    },
    "async_ras": {
        "async_ras_max_clusters": (_I, _I),
        "async_ras_f32": (_P,) * 19 + (_LL,) * 3 + (_I,) * 12
        + (_P, _F, _I, _P),
    },
    "async_ras_2d": {
        "async_ras_2d_max_clusters": (_I, _I),
        "async_ras_2d_f32": (_P,) * 15 + (_LL,) * 3 + (_I,) * 16
        + (_F, _I, _I, _P),
    },
    "async_ras_general": {
        "async_general_threads": (_I,),
        "async_general_max_ranks": (_I, _I),
        "async_general_f32": (_P,) * 20 + (_LL,) * 3 + (_I,) * 12
        + (_F, _I, _P),
    },
    "diagnostics": {
        "smoke_x2_f32": (_P, _P, _LL, _P),
        "flag_order_max_clusters": (_I,),
        "flag_order_probe": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
    "rdma_shift": {
        "rdma_shift_max_ranks": (_I, _I),
        "rdma_exchange": (_P,) * 11 + (_LL,) + (_I,) * 11 + (_P,),
    },
    "peer_window": {
        "peer_window_alloc": (_ULL, _P),
        "peer_window_handle": (_ULL, _P),
        "peer_window_open": (_P, _P),
        "peer_window_close": (_ULL,),
        "peer_window_free": (_ULL,),
        "peer_window_zero": (_ULL, _ULL, _ULL, _P),
        "peer_window_read": (_ULL, _ULL, _P, _ULL),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns the job, or None when the
    library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *_flags(name), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish_build(job) -> None:
    proc, tmp, out, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every kernel source not built yet, all nvcc runs at once
    (the span ``kernel_build`` when nvcc runs)."""
    jobs = [j for j in (_start_build(n) for n in names) if j is not None]
    if not jobs:
        return
    errors = []
    with span("kernel_build"):
        for job in jobs:
            try:
                _finish_build(job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def int_array(values) -> ctypes.Array:
    """Host int32 array for offsets the C entry points copy by value."""
    values = [int(v) for v in values]
    return (ctypes.c_int * max(len(values), 1))(*values)


def stream_ptr(device) -> int:
    """The raw handle of ``device``'s current stream (PyTorch's own getter,
    without building a ``torch.cuda.Stream``: this runs at every launch)."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check_operands(what: str, dtypes, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with one of ``dtypes`` (the kernels' only layout)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: operands must share one CUDA device, got "
                         f"{sorted(str(d) for d in devices)}")
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, "
                            f"expected one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
