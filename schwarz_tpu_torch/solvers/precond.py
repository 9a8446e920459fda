"""Local preconditioners: port of ``schwarz_tpu/solvers/precond.py`` for
``none`` and diagonal ``jacobi`` (block-Jacobi, FSAI(0) and ILU(0) wait for
a later slice).  The Jacobi inverse is built once on the host at setup; its
apply is ``dinv * r`` inside the local solve."""

from __future__ import annotations

import numpy as np


def extract_diagonal(vals: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """diag[s, r] = A_s[r, r] from batched ELL (S, R, W)."""
    rows = np.arange(vals.shape[1])[None, :, None]
    return np.where(cols == rows, vals, 0).sum(axis=-1)


def jacobi_inverse(vals: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """1 / diag(A) in the dtype of ``vals``, with 1 where the diagonal is
    zero (padding rows)."""
    d = extract_diagonal(vals, cols)
    return np.where(np.abs(d) > 0, 1.0 / np.where(d != 0, d, 1), 1.0).astype(
        vals.dtype)
