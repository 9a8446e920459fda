"""A plain solve of ``A x = b``: SciPy's sparse LU in the dtype given.  In
float64 it is the reference solution of the tests; in float32 it stands in
for the program in the control (the reference computed one precision below
what the configurations state)."""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla


def solve(A, b: np.ndarray, dtype=np.float64) -> np.ndarray:
    lu = spla.splu(A.astype(dtype).tocsc())
    return lu.solve(np.asarray(b, dtype))
