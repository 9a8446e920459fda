"""K2: the extended iterate ``x_ext``, whole, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/halo_pallas.py`` ``assemble_x_ext_fused`` (:216):
its XLA window insert and its DMA kernel ``assemble_runs_fused`` (:142),
which copies the halo runs.  One launch writes every element of a fresh
``(S, r_ext)`` tensor from a table of segments that the host builds once
per plan (:func:`build_segments`):

    segs  (NSEG, 4) int32   dst0, len, kind, src0; each row of x_ext cut
                            into sorted, non-overlapping segments
    first (S, n_tiles + 1)  int32: the first segment of each tile of
                            ``TILE`` columns, then the row's end

A segment is zero, a run of the subdomain's own interior window (read from
``x_own`` flat) or a run of the halo (read from ``halo_src`` flat, rounded
through ``halo_dtype``).  ``halo_src`` is ``x_own`` itself for the
``all_gather`` strategy, where the halo is made of runs of the gathered
interiors, and the compact ``(S, H)`` halo values for the neighbour
strategies.  The TPU kernel's 1024-element tile plan is a Mosaic layout rule
and has no counterpart here: segments start anywhere (source:
``csrc/halo_runs.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.ops import cuda_build

# segment kinds (csrc/halo_runs.cu)
ZERO, WINDOW, HALO = 0, 1, 2
# columns of x_ext one block writes: the unit of the ``first`` table
TILE = 4096
# the kernel's halo type codes
_HALO_CODES = {torch.float32: 1, torch.float64: 2, torch.bfloat16: 3,
               torch.float16: 4}
_COMPUTE = (torch.float32, torch.float64)


def n_tiles(r_ext: int) -> int:
    return -(-r_ext // TILE)


def build_segments(
    interior_off: np.ndarray,   # (S,) closure slot of each interior window
    r_int: int,
    r_ext: int,
    halo_slots: np.ndarray,     # (S, H) ext slot; r_ext = padding, unused
    halo_src: np.ndarray,       # (S, H) flat index into the halo source
    n_src: int,                 # length of the flat halo source
) -> Tuple[np.ndarray, np.ndarray]:
    """K2's tables ``(segs, first)`` (see the module's docstring).

    Paints each row of ``x_ext`` in the JAX package's write order: zero,
    then the window ``x_own[s, j - off_s]`` for ``off_s <= j < off_s +
    r_int`` (cut at ``r_ext``), then every used halo slot, which overwrites
    the window.  Neighbouring slots of one kind whose sources follow each
    other merge into one segment.  Raises when a halo slot is written twice
    (the scatter's order would decide it) or a source lies outside its
    array."""
    slots = np.asarray(halo_slots, np.int64)
    src = np.asarray(halo_src, np.int64)
    S = slots.shape[0]
    if max(S * r_int, n_src, r_ext) >= 2**31:
        raise ValueError("x_ext tables exceed int32 indices")
    used = slots < r_ext
    rows = np.nonzero(used)[0]
    cols, srcs = slots[used], src[used]
    if (slots < 0).any() or (srcs < 0).any() or (srcs >= n_src).any():
        raise ValueError("halo table reaches outside its arrays")
    if np.unique(rows * r_ext + cols).size != cols.size:
        raise ValueError("a halo slot is written twice")
    j = np.arange(r_ext)
    off = np.asarray(interior_off, np.int64)[:, None]
    kind = np.where((j >= off) & (j < off + r_int), WINDOW, 0).astype(np.int8)
    source = np.arange(S)[:, None] * r_int + j - off
    kind[rows, cols] = HALO
    source[rows, cols] = srcs
    source[kind == 0] = 0
    # a segment starts where the kind changes or the source jumps
    start = np.ones((S, r_ext), bool)
    start[:, 1:] = (kind[:, 1:] != kind[:, :-1]) | (
        (kind[:, 1:] != 0) & (source[:, 1:] != source[:, :-1] + 1))
    ss, dd = np.nonzero(start)
    row_ptr = np.searchsorted(ss, np.arange(S + 1))
    end = np.append(dd[1:], r_ext)
    end[row_ptr[1:] - 1] = r_ext
    segs = np.stack([dd, end - dd, kind[ss, dd], source[ss, dd]], 1)
    nt = n_tiles(r_ext)
    first = np.empty((S, nt + 1), np.int64)
    first[:, nt] = row_ptr[1:]
    for p in range(S):
        first[p, :nt] = row_ptr[p] + np.searchsorted(
            dd[row_ptr[p]:row_ptr[p + 1]], np.arange(nt) * TILE,
            side="right") - 1
    return (np.ascontiguousarray(segs, np.int32),
            np.ascontiguousarray(first, np.int32))


def assemble_x_ext_plain(x_own, halo_src, segs, first, r_ext: int,
                         halo_dtype: Optional[torch.dtype] = None):
    """The same ``x_ext`` as :func:`assemble_x_ext`, one slice assignment
    per segment of the table."""
    out = torch.empty((x_own.shape[0], r_ext), dtype=x_own.dtype,
                      device=x_own.device)
    xf, hf = x_own.reshape(-1), halo_src.reshape(-1)
    row_end = first[:, -1].tolist()
    s = 0
    for i, (d, n, kind, src) in enumerate(segs.tolist()):
        while i >= row_end[s]:
            s += 1
        if kind == ZERO:
            out[s, d:d + n] = 0
        elif kind == WINDOW:
            out[s, d:d + n] = xf[src:src + n]
        else:
            v = hf[src:src + n]
            if halo_dtype is not None:
                v = v.to(halo_dtype).to(x_own.dtype)
            out[s, d:d + n] = v
    return out


def assemble_x_ext(
    x_own: torch.Tensor,          # (S, R_int) every subdomain's interior
    halo_src: torch.Tensor,       # x_own (all_gather) or (S, H) halo values
    segs: torch.Tensor,           # (NSEG, 4) int32
    first: torch.Tensor,          # (S, n_tiles(r_ext) + 1) int32
    r_ext: int,
    halo_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x_ext`` (S, r_ext), contiguous; K2 on the card.  Halo values are
    rounded through ``halo_dtype`` when one is given.  The tables must come
    from :func:`build_segments`, which
    checks that every segment lies inside its source and its row."""
    if x_own.device.type == "cpu":
        return assemble_x_ext_plain(x_own, halo_src, segs, first, r_ext,
                                    halo_dtype)
    what = "assemble_x_ext"
    cuda_build.check_operands(what, _COMPUTE, x_own=x_own)
    cuda_build.check_operands(what, (x_own.dtype,), x_own=x_own,
                              halo_src=halo_src)
    cuda_build.check_operands(what, (torch.int32,), segs=segs, first=first)
    if halo_dtype is not None and halo_dtype not in _HALO_CODES:
        raise TypeError(f"{what}: halo_dtype {halo_dtype}; the kernel takes "
                        f"{tuple(_HALO_CODES)}")
    S = x_own.shape[0]
    if (x_own.dim() != 2 or segs.device != x_own.device
            or segs.dim() != 2 or segs.shape[1] != 4
            or segs.data_ptr() % 16
            or first.shape != (S, n_tiles(r_ext) + 1)):
        raise ValueError(
            f"{what}: x_own {tuple(x_own.shape)}, segs {tuple(segs.shape)}, "
            f"first {tuple(first.shape)} do not fit r_ext={r_ext}")
    out = torch.empty((S, r_ext), dtype=x_own.dtype, device=x_own.device)
    lib = cuda_build.library("halo_runs")
    fn = (lib.halo_assemble_f32 if x_own.dtype == torch.float32
          else lib.halo_assemble_f64)
    cuda_build.check(
        fn(out.data_ptr(), x_own.data_ptr(), halo_src.data_ptr(),
           segs.data_ptr(), first.data_ptr(), S, r_ext, n_tiles(r_ext),
           TILE, _HALO_CODES[halo_dtype or x_own.dtype],
           cuda_build.stream_ptr(x_own.device)),
        what)
    assemble_x_ext.launches += 1
    return out


assemble_x_ext.launches = 0
