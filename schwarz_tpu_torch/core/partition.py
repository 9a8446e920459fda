"""Partitioners: the port's copy of ``schwarz_tpu/core/partition.py`` for the
regular 1-D partition (reference restricted_schwarz.cpp:84,98-102).  The
regular 2-D and METIS-equivalent partitioners wait for a later slice."""

from __future__ import annotations

import numpy as np

from schwarz_tpu_torch.exceptions import NotImplementedFeature, PartitionError
from schwarz_tpu_torch.models.csr import CSRMatrix


def first_occurrence_unique(a: np.ndarray) -> np.ndarray:
    """Unique values of ``a`` in first-occurrence order (the reference's
    scan-order marking of global_to_local, restricted_schwarz.cpp:167-180)."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def _csr_row_gather(row_ptrs: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Indices into col_idxs covering all entries of ``rows``, row-major order."""
    starts = row_ptrs[rows]
    counts = row_ptrs[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    offsets = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return offsets + np.arange(total, dtype=np.int64)


def partition_regular_1d(
    n: int, nparts: int, cell_weights=None,
) -> np.ndarray:
    """Contiguous equal blocks of ``ceil(n/nparts)`` rows
    (restricted_schwarz.cpp:84,98-102: ``nb = (n + S - 1) / S``).

    When that formula would leave trailing parts empty the split is balanced
    instead (sizes differ by at most one).  With ``cell_weights`` the block
    boundaries equalize cumulative weight; parts stay contiguous and
    non-empty.
    """
    if cell_weights is None:
        nb = -(-n // nparts)
        if (nparts - 1) * nb >= n:
            if n < nparts:
                raise PartitionError(
                    f"cannot split {n} rows into {nparts} non-empty parts"
                )
            base, extra = divmod(n, nparts)
            sizes = np.full(nparts, base, dtype=np.int64)
            sizes[:extra] += 1
            return np.repeat(
                np.arange(nparts, dtype=np.int32), sizes
            )
        return np.minimum(
            np.arange(n, dtype=np.int64) // nb, nparts - 1
        ).astype(np.int32)
    w = np.asarray(cell_weights, dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"cell_weights has shape {w.shape}, expected ({n},)")
    cw = np.cumsum(w)
    total = cw[-1] if cw[-1] > 0 else 1.0
    bounds = np.searchsorted(
        cw, total * np.arange(1, nparts) / nparts, side="left"
    ).astype(np.int64)
    # enforce non-empty contiguous parts
    for k in range(bounds.size):
        lo = (bounds[k - 1] if k else 0) + 1
        bounds[k] = min(max(bounds[k], lo), n - (bounds.size - k))
    part = np.zeros(n, dtype=np.int32)
    part[bounds] += 1
    return np.cumsum(part).astype(np.int32)


def make_partition(
    mat: CSRMatrix, nparts: int, settings, cell_weights=None,
) -> np.ndarray:
    """Dispatch on Settings.partition (cf. Initialize::partition,
    source/initialization.cpp:278-329); only ``regular`` is ported."""
    from schwarz_tpu_torch.config import Partition

    if cell_weights is not None:
        cell_weights = np.asarray(cell_weights)
        if cell_weights.shape != (mat.n,):
            raise ValueError(
                f"cell_weights must have shape ({mat.n},) — one weight per "
                f"matrix row — got {cell_weights.shape}"
            )
        if (cell_weights < 0).any():
            raise ValueError("cell_weights must be non-negative")
    if nparts == 1:
        return np.zeros(mat.n, dtype=np.int32)
    if settings.partition == Partition.regular:
        return partition_regular_1d(mat.n, nparts, cell_weights)
    raise NotImplementedFeature(
        f"partition={settings.partition.value!r} is not ported yet; the "
        "port supports the regular 1-D partition"
    )
