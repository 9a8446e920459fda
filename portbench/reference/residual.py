"""The check of one solve: the true relative residual ``||b - A x|| /
||b||`` in float64, against the benchmark's own operator and right-hand
side (the reference's oracle, schwarz-lib ``source/solve.cpp:1024-1085``)."""

from __future__ import annotations

import numpy as np


def relative_residual(A, b: np.ndarray, x: np.ndarray) -> float:
    """``inf`` for a solution of the wrong shape or with a non-finite
    entry."""
    b = np.asarray(b, np.float64).reshape(-1)
    x = np.asarray(x).reshape(-1)
    if x.shape != b.shape or not np.isfinite(x).all():
        return float("inf")
    r = b - A @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))
