"""K1: the batched DIA SpMV, a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernels of ``schwarz_tpu/ops/pallas_kernels.py``:
``dia_spmv_pallas3`` (:110) and its earlier generations ``dia_spmv_pallas2d``
(:38) and ``dia_spmv_pallas`` (:182).  It computes

    y[s, r] = sum_k dia_vals[s, k, r] * x[s, r + off_k]      (0 <= r < R)

with reads of x outside ``[0, R)`` taken as zero, in float32 and float64
(source: ``csrc/dia_spmv.cu``).  The kernel is bound by memory traffic
(dia + x + y); one thread per output keeps every access coalesced.

:func:`dia_spmv` launches the kernel for CUDA tensors and uses
:func:`dia_spmv_plain`, the same function in plain PyTorch, only for CPU
tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from schwarz_tpu_torch.ops import cuda_build


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
    cuda_build.check_operands("dia_spmv", (torch.float32, torch.float64),
                              dia_vals=dia_vals)
    if x.device != dia_vals.device or x.dtype != dia_vals.dtype:
        raise ValueError("dia_spmv: x must match dia_vals' device and dtype")
    if x.dim() != 2 or x.shape[0] != S or x.shape[1] < R or x.stride(1) != 1:
        raise ValueError(
            f"dia_spmv: x must be (S={S}, >= {R}) with unit column stride, "
            f"got shape {tuple(x.shape)} strides {x.stride()}")
    if len(offsets) != K or K > 32:
        raise ValueError(
            f"dia_spmv: {len(offsets)} offsets for {K} diagonals (max 32)")
    y = torch.empty((S, R), dtype=x.dtype, device=x.device)
    lib = cuda_build.library("dia_spmv")
    fn = lib.dia_spmv_f32 if x.dtype == torch.float32 else lib.dia_spmv_f64
    cuda_build.check(
        fn(dia_vals.data_ptr(), x.data_ptr(), y.data_ptr(), S, K, R,
           x.stride(0), cuda_build.int_array(offsets),
           cuda_build.stream_ptr(x.device)),
        "dia_spmv")
    dia_spmv.launches += 1
    key = (tuple(offsets), str(x.dtype).removeprefix("torch."))
    dia_spmv.launches_by[key] = dia_spmv.launches_by.get(key, 0) + 1
    return y


# launches in all, and by operand: (offsets, dtype name) -> launches
dia_spmv.launches = 0
dia_spmv.launches_by = {}
