"""The 2-D 5-point Laplacian on an ``n x n`` grid, as schwarz-lib's
``--explicit_laplacian`` generates it (``source/initialization.cpp:
214-265``): row ``i = y n + x`` holds 4 on the diagonal and -1 towards
``i - n``, ``i - 1``, ``i + 1`` and ``i + n``, without the couplings that
would wrap across a grid row's end.  ``n^2`` rows, ``5 n^2 - 4 n``
nonzeros."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def build(spec: dict) -> sp.csr_matrix:
    n = int(spec["n"])
    N = n * n
    ones = np.ones(N)
    side = -ones.copy()
    side[np.arange(N) % n == n - 1] = 0.0       # no (x = n-1) -> (x+1) link
    A = sp.diags([-ones[:N - n], side[:N - 1], 4 * ones, side[:N - 1],
                  -ones[:N - n]], [-n, -1, 0, 1, n], format="csr")
    A.eliminate_zeros()
    A.sort_indices()
    return A
