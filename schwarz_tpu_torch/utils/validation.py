"""Validation helpers, a copy of ``schwarz_tpu/utils/validation.py``
(reference C28: Utils::assert_correct_permutation
utils.cpp:127-152, duplicate finder, CSV matrix dumps)."""

from __future__ import annotations

import numpy as np


def validate_permutation(perm: np.ndarray) -> bool:
    """True iff ``perm`` is a bijection on [0, n) (utils.cpp:127-152)."""
    n = perm.shape[0]
    seen = np.zeros(n, dtype=bool)
    if perm.min() < 0 or perm.max() >= n:
        return False
    seen[perm] = True
    return bool(seen.all())


def find_duplicates(arr: np.ndarray, value) -> int:
    """Count occurrences of ``value`` (reference Utils::find_duplicates)."""
    return int((np.asarray(arr) == value).sum())


def dump_csr_csv(mat, path: str) -> None:
    """row,col,value dump of a CSRMatrix (utils.cpp:93-108 print_matrix)."""
    with open(path, "w") as f:
        f.write("row,col,value\n")
        for i in range(mat.n):
            for k in range(mat.row_ptrs[i], mat.row_ptrs[i + 1]):
                f.write(f"{i},{mat.col_idxs[k]},{mat.values[k]:.17g}\n")
