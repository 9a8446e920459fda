"""DIA(+ELL-remainder) local operator: the port of ``schwarz_tpu/ops/dia.py``.

Banded operators store their dominant diagonals densely and the few entries
off them in a row-compacted ELL remainder:

    y[r] = sum_k dia_vals[k, r] * x[r + off_k]   +   (ELL remainder)

The split (:func:`split_dia_ell`) is host numpy, identical to the JAX
package's.  The diagonal product is kernel K1
(:func:`schwarz_tpu_torch.ops.dia_kernel.dia_spmv`); the remainder is a torch
gather and scatter.  The card has native float64 gathers, so the TPU's hi/lo
float32 split of emulated float64 (``ops/f64_split.py``) is not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from schwarz_tpu_torch.ops.dia_kernel import dia_spmv

__all__ = ["DiaEllMatrices", "split_dia_ell", "dia_ell_spmv", "dia_spmv",
           "apply_remainder"]


@dataclasses.dataclass
class DiaEllMatrices:
    """Batched hybrid operator for all subdomains of a decomposition (host).

    The remainder is row-compacted: only rows that carry off-diagonal
    remainder entries appear (padded with the scratch row index ``R_rows``).
    """

    offsets: Tuple[int, ...]        # shared diagonal offsets (static)
    dia_vals: np.ndarray            # (S, K, R_rows)
    rem_rows: np.ndarray            # (S, Or) int32 row index; R_rows = scratch
    rem_vals: np.ndarray            # (S, Or, Wr) ELL remainder
    rem_cols: np.ndarray            # (S, Or, Wr)
    n_rows: int                     # R_rows
    max_abs_offset: int


def split_dia_ell(
    ell_vals: np.ndarray,           # (S, R_rows, W)
    ell_cols: np.ndarray,           # (S, R_rows, W)
    rows_count: np.ndarray,         # (S,)
    max_diags: int = 16,
    min_fill: float = 0.02,
) -> DiaEllMatrices:
    """Extract the dominant diagonals of a batched ELL matrix.

    An offset qualifies if its entries cover at least ``min_fill`` of the total
    nonzeros (across the whole batch); at most ``max_diags`` offsets are kept.
    Chosen entries move to the dense diagonals, everything else stays in a
    re-packed ELL remainder.
    """
    S, R, W = ell_vals.shape
    rows = np.arange(R, dtype=np.int64)[None, :, None]
    nz = ell_vals != 0.0
    delta = ell_cols.astype(np.int64) - rows

    # histogram of col-row offsets over true nonzeros
    deltas_nz = delta[nz]
    total = max(deltas_nz.size, 1)
    uniq, counts = np.unique(deltas_nz, return_counts=True)
    order = np.argsort(-counts)
    chosen = []
    for i in order[:max_diags]:
        if counts[i] >= min_fill * total:
            chosen.append(int(uniq[i]))
    chosen = tuple(sorted(chosen))
    K = len(chosen)

    dia_vals = np.zeros((S, max(K, 1), R), dtype=ell_vals.dtype)
    off_to_k = {off: k for k, off in enumerate(chosen)}

    on_dia = np.zeros_like(nz)
    for off, k in off_to_k.items():
        sel = nz & (delta == off)
        # rows can hold at most one entry per diagonal (unique columns per row)
        s_idx, r_idx, w_idx = np.nonzero(sel)
        dia_vals[s_idx, k, r_idx] = ell_vals[s_idx, r_idx, w_idx]
        on_dia |= sel

    rem = nz & ~on_dia
    rem_per_row = rem.sum(axis=2)                    # (S, R)
    Wr = max(int(rem_per_row.max()) if rem_per_row.size else 0, 1)
    rows_with_rem = rem_per_row > 0
    Or = max(int(rows_with_rem.sum(axis=1).max()), 1)
    rem_rows = np.full((S, Or), R, dtype=np.int32)   # scratch row = R
    rem_cols = np.zeros((S, Or, Wr), dtype=np.int32)
    rem_vals = np.zeros((S, Or, Wr), dtype=ell_vals.dtype)
    for s in range(S):
        rws = np.nonzero(rows_with_rem[s])[0]
        rem_rows[s, : rws.size] = rws.astype(np.int32)
        for j, r in enumerate(rws):
            w_idx = np.nonzero(rem[s, r])[0]
            rem_cols[s, j, : w_idx.size] = ell_cols[s, r, w_idx]
            rem_vals[s, j, : w_idx.size] = ell_vals[s, r, w_idx]

    return DiaEllMatrices(
        offsets=chosen,
        dia_vals=dia_vals,
        rem_rows=rem_rows,
        rem_vals=rem_vals,
        rem_cols=rem_cols,
        n_rows=R,
        max_abs_offset=max((abs(o) for o in chosen), default=0),
    )


def apply_remainder(
    rem_rows: torch.Tensor,         # (S, Or) int64; R = scratch row
    rem_vals: torch.Tensor,         # (S, Or, Wr)
    rem_cols: torch.Tensor,         # (S, Or, Wr) int64
    x: torch.Tensor,                # (S, Rx)
    y: torch.Tensor,                # (S, R)
) -> torch.Tensor:
    """y plus the row-compact ELL remainder (gather volume O(Or * Wr)).
    Remainder rows are unique per subdomain; pads target the scratch row R,
    which is sliced away."""
    S, R = y.shape
    gathered = torch.gather(x, 1, rem_cols.reshape(S, -1)).reshape(
        rem_cols.shape)
    rem_y = torch.sum(rem_vals * gathered, dim=-1)           # (S, Or)
    ypad = torch.nn.functional.pad(y, (0, 1))
    return ypad.scatter_add(1, rem_rows, rem_y)[:, :R]


def dia_ell_spmv(
    offsets: Tuple[int, ...],
    dia_vals: torch.Tensor,         # (S, K, R)
    rem_rows: torch.Tensor,         # (S, Or) int64
    rem_vals: torch.Tensor,         # (S, Or, Wr)
    rem_cols: torch.Tensor,         # (S, Or, Wr) int64
    x: torch.Tensor,                # (S, Rx) with Rx >= R
    has_remainder: bool = True,
) -> torch.Tensor:
    """y (S, R) = (DIA + row-compact ELL remainder) @ x.  With
    ``has_remainder=False`` (an all-zero remainder, e.g. regular 1-D
    partitions of stencil matrices) the remainder pass is skipped: it would
    add exact zeros to the scratch row only."""
    y = dia_spmv(offsets, dia_vals, x)
    if not has_remainder:
        return y
    return apply_remainder(rem_rows, rem_vals, rem_cols, x, y)
