"""Exception hierarchy, a copy of ``schwarz_tpu/exceptions.py`` (reference
C27: include/exception.hpp:42-213 — Error base with file:line context;
NotImplemented/BadDimension/vendor errors — and the assertion macros of
exception_helpers.hpp:45-124).

Python tracebacks already carry location context, so this package keeps only
the semantic hierarchy plus light-weight assertion helpers used at setup
boundaries (dimension checks, partition validation).
"""

from __future__ import annotations

import numpy as np


class SchwarzError(Exception):
    """Base error (reference schwz::Error, exception.hpp:42-76)."""


class NotImplementedFeature(SchwarzError):
    """Feature declared but not implemented (SCHWARZ_NOT_IMPLEMENTED,
    exception_helpers.hpp:45-56)."""


class ModuleNotImplementedFeature(NotImplementedFeature):
    """A whole module/backend is unavailable (exception.hpp:106-128)."""


class BadDimension(SchwarzError):
    """Dimension mismatch (exception.hpp:131-160; SCHWARZ_ASSERT_EQ and the
    square-matrix asserts of exception_helpers.hpp:58-124)."""


class PartitionError(SchwarzError):
    """Invalid partition (non-bijective permutation, empty/oversized parts —
    the runtime permutation validation of utils.cpp:127-152)."""


class ConvergenceError(SchwarzError):
    """Solver diverged (the divergence abort of schwarz_base.cpp:424-428 and
    the NaN-residual exit of solve.cpp:982-984), surfaced as an exception
    instead of std::exit(-1)."""


def assert_square(n_rows: int, n_cols: int, what: str = "matrix") -> None:
    if n_rows != n_cols:
        raise BadDimension(f"{what} must be square, got {n_rows}x{n_cols}")


def assert_eq(a, b, what: str = "dimensions") -> None:
    if a != b:
        raise BadDimension(f"{what} mismatch: {a} != {b}")


def assert_valid_partition(partition_indices: np.ndarray, nparts: int) -> None:
    p = np.asarray(partition_indices)
    if p.size == 0 or nparts < 1:
        raise PartitionError(
            f"empty partition (got {p.size} indices for {nparts} parts)"
        )
    if not np.issubdtype(p.dtype, np.integer):
        raise PartitionError(
            f"partition indices must be integers, got dtype {p.dtype}"
        )
    if p.min() < 0 or p.max() >= nparts:
        raise PartitionError(
            f"partition indices out of range [0, {nparts}): "
            f"min={p.min()}, max={p.max()}"
        )
    counts = np.bincount(p, minlength=nparts)
    if (counts == 0).any():
        empty = np.nonzero(counts == 0)[0]
        raise PartitionError(
            f"empty subdomain(s) {empty.tolist()[:8]} in a {nparts}-part "
            "partition: every part needs at least one row (an empty part "
            "has no interior to solve and crashes the decomposition)"
        )
