"""Host-side CSR matrix container.

The reference uses ``gko::matrix::Csr`` for the global matrix living on the host
before decomposition (source/initialization.cpp:196-272).  Here the global matrix is
a plain numpy CSR triple; it exists only during setup — device-side matrices are
padded batched ELL (see :mod:`schwarz_tpu_torch.core.decompose`).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """CSR triple with square shape, sorted column indices within each row."""

    row_ptrs: np.ndarray   # (n+1,) int64
    col_idxs: np.ndarray   # (nnz,) int64
    values: np.ndarray     # (nnz,) float
    n: int

    @property
    def nnz(self) -> int:
        return int(self.row_ptrs[-1])

    @classmethod
    def from_coo(cls, rows, cols, vals, n) -> "CSRMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        row_ptrs = np.zeros(n + 1, dtype=np.int64)
        np.add.at(row_ptrs, rows + 1, 1)
        np.cumsum(row_ptrs, out=row_ptrs)
        return cls(row_ptrs=row_ptrs, col_idxs=cols, values=vals, n=n)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.values, self.col_idxs, self.row_ptrs), shape=(self.n, self.n)
        )

    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        m = m.tocsr()
        m.sort_indices()
        return cls(
            row_ptrs=m.indptr.astype(np.int64),
            col_idxs=m.indices.astype(np.int64),
            values=np.asarray(m.data),
            n=m.shape[0],
        )

    def sort_columns(self) -> "CSRMatrix":
        """Sort column indices within each row (cf. Csr::sort_by_column_index)."""
        for i in range(self.n):
            s, e = self.row_ptrs[i], self.row_ptrs[i + 1]
            order = np.argsort(self.col_idxs[s:e], kind="stable")
            self.col_idxs[s:e] = self.col_idxs[s:e][order]
            self.values[s:e] = self.values[s:e][order]
        return self

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host reference SpMV (for tests/oracles only)."""
        y = np.zeros(self.n, dtype=np.result_type(self.values, x))
        for i in range(self.n):
            s, e = self.row_ptrs[i], self.row_ptrs[i + 1]
            y[i] = self.values[s:e] @ x[self.col_idxs[s:e]]
        return y
