"""2-D 5-point Laplacian generator.

Matches the reference's in-house generator semantics
(source/initialization.cpp:214-265): for an ``n x n`` grid (global size ``n**2``) the
stencil is ``{-n: -1, -1: -1, 0: 4, +1: -1, +n: -1}`` with east/west couplings that
would wrap across a grid-row boundary excluded (the "exclusion set",
initialization.cpp:225-242).  Dirichlet boundary handled implicitly by dropping
out-of-range offsets.
"""

from __future__ import annotations

import numpy as np

from schwarz_tpu_torch.models.csr import CSRMatrix


def laplacian_2d(n: int, dtype=np.float64) -> CSRMatrix:
    """5-point Laplacian on an ``n x n`` grid; returns ``n**2 x n**2`` CSR.

    Row ``i`` couples to ``i-n, i-1, i, i+1, i+n`` (columns in increasing order,
    matching the sorted stencil map iteration of initialization.cpp:248-264) except
    where ``i-1``/``i+1`` cross a grid-row boundary.
    """
    N = n * n
    i = np.arange(N, dtype=np.int64)
    col_in_grid = i % n

    offsets = np.array([-n, -1, 0, 1, n], dtype=np.int64)
    stencil = np.array([-1.0, -1.0, 4.0, -1.0, -1.0], dtype=dtype)

    cols = i[:, None] + offsets[None, :]               # (N, 5)
    vals = np.broadcast_to(stencil, (N, 5)).copy()
    valid = (cols >= 0) & (cols < N)
    # exclusion set: no west coupling from the first column of a grid row, no east
    # coupling from the last column (initialization.cpp:231-239)
    valid[:, 1] &= col_in_grid != 0
    valid[:, 3] &= col_in_grid != n - 1

    rows = np.broadcast_to(i[:, None], (N, 5))
    return CSRMatrix.from_coo(rows[valid], cols[valid], vals[valid], N)
