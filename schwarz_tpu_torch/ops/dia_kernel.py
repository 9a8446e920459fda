"""K1: the batched DIA SpMV, a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernels of ``schwarz_tpu/ops/pallas_kernels.py``:
``dia_spmv_pallas3`` (:110) and its earlier generations ``dia_spmv_pallas2d``
(:38) and ``dia_spmv_pallas`` (:182).  It computes

    y[s, r] = sum_k dia_vals[s, k, r] * x[s, r + off_k]      (0 <= r < R)

with reads of x outside ``[0, R)`` taken as zero, in float32 and float64
(source: ``csrc/dia_spmv.cu``), and in one launch the chained product
``DIA_out @ (DIA_in @ x)`` that FSAI's apply ``G^T (G r)`` runs, the inner
product kept in shared memory.  The kernel is bound by memory traffic (dia +
x + y) and, at the solver's shapes, by its launch.

:func:`dia_spmv` and :func:`dia_spmv_chain` launch the kernel for CUDA
tensors and use :func:`dia_spmv_plain` / :func:`dia_spmv_chain_plain`, the
same functions in plain PyTorch, only for CPU tensors.  Each launch adds one
to ``dia_spmv.launches`` and to ``dia_spmv.launches_by`` under its operand's
key: ``(offsets, dtype name)`` for one product, ``("chain", offsets_in,
offsets_out, dtype name)`` for a chain.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from schwarz_tpu_torch.ops import cuda_build

# the chain's tile rows and its shared window's bytes at most
# (csrc/dia_spmv.cu kSmemMax)
MAX_TILE = 2048
WINDOW_BYTES_MAX = 48 * 1024
_NAMES = {torch.float32: "float32", torch.float64: "float64"}

# per operand, what does not change between calls: (offsets, dtype) or
# ("chain", offsets_in, offsets_out, dtype) -> (entry point, ctypes
# offsets, launch key)
_operands: dict = {}
_sm_counts: dict = {}


def dia_spmv_plain(
    offsets: Tuple[int, ...],
    dia_vals: torch.Tensor,        # (S, K, R)
    x: torch.Tensor,               # (S, Rx), Rx >= R
) -> torch.Tensor:
    """Shift-multiply-add over a zero-padded copy of ``x[:, :R]`` (the
    formulation of ``schwarz_tpu/ops/dia.py`` dia_spmv)."""
    S, _, R = dia_vals.shape
    M = max((abs(o) for o in offsets), default=0)
    xp = F.pad(x[:, :R], (M, M))
    y = torch.zeros((S, R), dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        y = y + dia_vals[:, k, :] * xp[:, M + off:M + off + R]
    return y


def dia_spmv_chain_plain(offsets_in, dia_in, offsets_out, dia_out, x):
    """``DIA_out @ (DIA_in @ x[:, :R])`` as two plain products: the inner
    product's result is read as zero outside ``[0, R)``."""
    return dia_spmv_plain(offsets_out, dia_out,
                          dia_spmv_plain(offsets_in, dia_in, x))


def window_fits(offsets, dtype, tile: int) -> bool:
    """Whether a tile of ``tile`` rows and the span of ``offsets`` fit the
    chain's shared window (``csrc/dia_spmv.cu`` launch_chain)."""
    rows = tile + max(offsets) - min(offsets)
    return rows * (4 if dtype == torch.float32 else 8) <= WINDOW_BYTES_MAX


def default_tile(S: int, R: int, device) -> int:
    """The chain's rows a block: about two blocks per SM over the S
    subdomains (one wave), a multiple of 32 from 256 to ``MAX_TILE``."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    rows = math.ceil(R / max(1, 2 * n // S))
    return min(MAX_TILE, max(256, 32 * math.ceil(rows / 32)))


def _check(what: str, x: torch.Tensor, **dias) -> None:
    """The kernel's layout: dias contiguous (S, K, R) CUDA tensors of one
    dtype, x on their device with that dtype, (S, >= R), unit column
    stride."""
    cuda_build.check_operands(what, (torch.float32, torch.float64), **dias)
    first = next(iter(dias.values()))
    S, _, R = first.shape
    for name, d in dias.items():
        if d.dtype != first.dtype or d.shape[0] != S or d.shape[2] != R:
            raise ValueError(f"{what}: {name} must be ({S}, K, {R}) "
                             f"{first.dtype}, got {tuple(d.shape)} {d.dtype}")
    if x.device != first.device or x.dtype != first.dtype:
        raise ValueError(f"{what}: x must match the diagonals' device and "
                         f"dtype")
    if x.dim() != 2 or x.shape[0] != S or x.shape[1] < R or x.stride(1) != 1:
        raise ValueError(
            f"{what}: x must be (S={S}, >= {R}) with unit column stride, "
            f"got shape {tuple(x.shape)} strides {x.stride()}")


def _check_offsets(what: str, offsets, dia: torch.Tensor) -> None:
    K = dia.shape[1]
    if len(offsets) != K or K > 32:
        raise ValueError(
            f"{what}: {len(offsets)} offsets for {K} diagonals (max 32)")


def _operand(key, make):
    op = _operands.get(key)
    if op is None:
        op = _operands[key] = make(cuda_build.library("dia_spmv"))
    return op


def dia_spmv(
    offsets: Tuple[int, ...],
    dia_vals: torch.Tensor,        # (S, K, R) contiguous
    x: torch.Tensor,               # (S, Rx), Rx >= R, unit column stride
) -> torch.Tensor:
    """y (S, R) = DIA(offsets, dia_vals) @ x[:, :R]; K1 on the card."""
    S, K, R = dia_vals.shape
    if x.device.type == "cpu" or not offsets:
        # no diagonals (an operator with only an ELL part) is a zero product
        return dia_spmv_plain(offsets, dia_vals, x)
    _check("dia_spmv", x, dia_vals=dia_vals)
    _check_offsets("dia_spmv", offsets, dia_vals)
    offsets, dt = tuple(offsets), x.dtype
    fn, c_offs, key = _operand((offsets, dt), lambda lib: (
        lib.dia_spmv_f32 if dt == torch.float32 else lib.dia_spmv_f64,
        cuda_build.int_array(offsets), (offsets, _NAMES[dt])))
    y = torch.empty((S, R), dtype=dt, device=x.device)
    cuda_build.check(
        fn(dia_vals.data_ptr(), x.data_ptr(), y.data_ptr(), S, K, R,
           x.stride(0), c_offs, cuda_build.stream_ptr(x.device)),
        "dia_spmv")
    dia_spmv.launches += 1
    dia_spmv.launches_by[key] = dia_spmv.launches_by.get(key, 0) + 1
    return y


def dia_spmv_chain(offsets_in, dia_in, offsets_out, dia_out, x, tile=None):
    """z (S, R) = DIA(offsets_out, dia_out) @ (DIA(offsets_in, dia_in) @
    x[:, :R]), the inner product read as zero outside ``[0, R)``; on the
    card one K1 launch over tiles of ``tile`` rows (:func:`default_tile`),
    the inner product kept in shared memory, equal bit for bit to two
    :func:`dia_spmv` launches.  When a tile's window (``tile`` rows and the
    span of ``offsets_out``) does not fit :data:`WINDOW_BYTES_MAX`, it runs
    as those two K1 launches and is counted as two."""
    S, K_in, R = dia_in.shape
    if x.device.type == "cpu":
        return dia_spmv_chain_plain(offsets_in, dia_in, offsets_out, dia_out,
                                    x)
    _check("dia_spmv_chain", x, dia_in=dia_in, dia_out=dia_out)
    _check_offsets("dia_spmv_chain", offsets_in, dia_in)
    _check_offsets("dia_spmv_chain", offsets_out, dia_out)
    tile = default_tile(S, R, x.device) if tile is None else int(tile)
    if tile < 1:
        raise ValueError(f"dia_spmv_chain: tile {tile} < 1")
    if (not offsets_in or not offsets_out
            or not window_fits(offsets_out, x.dtype, tile)):
        return dia_spmv(offsets_out, dia_out,
                        dia_spmv(offsets_in, dia_in, x))
    oi, oo, dt = tuple(offsets_in), tuple(offsets_out), x.dtype
    fn, (c_in, c_out), key = _operand(("chain", oi, oo, dt), lambda lib: (
        lib.dia_spmv_chain_f32 if dt == torch.float32
        else lib.dia_spmv_chain_f64,
        (cuda_build.int_array(oi), cuda_build.int_array(oo)),
        ("chain", oi, oo, _NAMES[dt])))
    z = torch.empty((S, R), dtype=dt, device=x.device)
    cuda_build.check(
        fn(dia_in.data_ptr(), dia_out.data_ptr(), x.data_ptr(), z.data_ptr(),
           S, K_in, dia_out.shape[1], R, x.stride(0), c_in, c_out, tile,
           cuda_build.stream_ptr(x.device)),
        "dia_spmv_chain")
    dia_spmv.launches += 1
    dia_spmv.launches_by[key] = dia_spmv.launches_by.get(key, 0) + 1
    return z


# launches in all, and by operand: (offsets, dtype name) -> launches, and
# ("chain", offsets_in, offsets_out, dtype name) -> launches
dia_spmv.launches = 0
dia_spmv.launches_by = {}
