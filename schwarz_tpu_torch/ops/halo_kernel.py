"""K2: the halo-run copy of the extended iterate, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/halo_pallas.py`` ``assemble_runs_fused`` (:142).
Each subdomain's halo is a few contiguous runs of the gathered interior
blocks; the runs of every length class come flattened into one table

    src (S, NR) int32, dst (S, NR) int32, lens (NR,) int32

and one launch copies ``buf[s, dst : dst + len] = x_all[src : src + len]``
for every entry, skipping the sentinel ``dst == r_ext`` (source:
``csrc/halo_runs.cu``).  The TPU kernel's 1024-element tile plan is a Mosaic
layout rule and has no counterpart here: runs start anywhere.

The copy writes into ``buf`` IN PLACE.  ``buf`` already holds the interior
window (written in PyTorch by :func:`schwarz_tpu_torch.parallel.exchange.
window_insert`); the runs overwrite it afterwards, the write order of the
XLA paths, so the result is bit-identical to them.
"""

from __future__ import annotations

import torch

from schwarz_tpu_torch.ops import cuda_build


def assemble_runs_plain(buf, x_all_flat, src, dst, lens, r_ext: int):
    """The same copies as :func:`assemble_runs`, one slice assignment each."""
    src_l, dst_l, lens_l = src.tolist(), dst.tolist(), lens.tolist()
    for s in range(buf.shape[0]):
        for j, length in enumerate(lens_l):
            d = dst_l[s][j]
            if d < r_ext:
                buf[s, d:d + length] = x_all_flat[src_l[s][j]:
                                                  src_l[s][j] + length]
    return buf


def assemble_runs(
    buf: torch.Tensor,             # (S, ldb >= r_ext), unit column stride
    x_all_flat: torch.Tensor,      # (S_total * R_int,)
    src: torch.Tensor,             # (S, NR) int32
    dst: torch.Tensor,             # (S, NR) int32; r_ext = unused entry
    lens: torch.Tensor,            # (NR,) int32
    r_ext: int,
) -> torch.Tensor:
    """Copy every halo run into ``buf`` in place and return it; K2 on the
    card.  The tables must come from
    :func:`schwarz_tpu_torch.parallel.exchange.flat_run_tables`, which
    checks that every run lies inside both arrays."""
    if buf.device.type == "cpu":
        return assemble_runs_plain(buf, x_all_flat, src, dst, lens, r_ext)
    cuda_build.check_operands("assemble_runs", (buf.dtype,),
                              x_all_flat=x_all_flat)
    cuda_build.check_operands("assemble_runs", (torch.int32,), src=src,
                              dst=dst, lens=lens)
    if buf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"assemble_runs: unsupported dtype {buf.dtype}")
    S, NR = src.shape
    if (buf.device != x_all_flat.device or src.device != buf.device
            or buf.dim() != 2 or buf.shape[0] != S or buf.shape[1] < r_ext
            or buf.stride(1) != 1 or dst.shape != (S, NR)
            or lens.shape != (NR,)):
        raise ValueError(
            f"assemble_runs: buf {tuple(buf.shape)} / tables "
            f"{tuple(src.shape)}, {tuple(dst.shape)}, {tuple(lens.shape)} "
            f"do not fit r_ext={r_ext}")
    lib = cuda_build.library("halo_runs")
    fn = lib.halo_runs_f32 if buf.dtype == torch.float32 else lib.halo_runs_f64
    cuda_build.check(
        fn(buf.data_ptr(), buf.stride(0), x_all_flat.data_ptr(),
           src.data_ptr(), dst.data_ptr(), lens.data_ptr(), S, NR, r_ext,
           cuda_build.stream_ptr(buf.device)),
        "assemble_runs")
    assemble_runs.launches += 1
    return buf


assemble_runs.launches = 0
