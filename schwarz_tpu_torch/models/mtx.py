"""MatrixMarket reader (reference reads .mtx via Ginkgo,
source/initialization.cpp:204-213, then sorts columns)."""

from __future__ import annotations

import numpy as np

from schwarz_tpu_torch.models.csr import CSRMatrix


def read_mtx(path: str, dtype=np.float64) -> CSRMatrix:
    """Read a MatrixMarket coordinate file into CSR (symmetric storage expanded)."""
    with open(path, "r") as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        # "skew-symmetric" contains "symmetric" as a substring: mirrored
        # entries must be NEGATED there (A[j,i] = -A[i,j]); "hermitian"
        # reduces to symmetric for the real data this reader supports
        skew = "skew-symmetric" in header
        symmetric = (
            "symmetric" in header or "hermitian" in header
        ) and not skew
        pattern = "pattern" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(t) for t in line.split())
        data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)

    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = (
        np.ones(len(rows), dtype=dtype) if pattern else data[:, 2].astype(dtype)
    )
    if symmetric or skew:
        off = rows != cols
        rows, cols = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
        )
        mirrored = -vals[off] if skew else vals[off]
        vals = np.concatenate([vals, mirrored])
    from schwarz_tpu_torch.exceptions import assert_square

    assert_square(nrows, ncols, f"matrix {path}")
    return CSRMatrix.from_coo(rows, cols, vals, nrows)


def write_mtx(path: str, mat: CSRMatrix, comment: str = "") -> None:
    """Write CSR as a MatrixMarket ``coordinate real general`` file.

    Values print with ``%.17g`` so a read_mtx round-trip reproduces the
    exact float64 bits.  Used to vendor the reference's test inputs
    (matrices/ani{3,4}_crop.mtx) in-repo as regenerated copies.
    """
    indptr, cols, vals = mat.row_ptrs, mat.col_idxs, mat.values
    rows = np.repeat(np.arange(mat.n, dtype=np.int64),
                     np.diff(indptr).astype(np.int64))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        for ln in comment.splitlines():
            f.write(f"% {ln}\n")
        f.write(f"{mat.n} {mat.n} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")


def matrix_path(name: str) -> str:
    """Resolve a vendored test matrix in the repository's ``matrices/``
    (provenance: reference matrices/ani3_crop.mtx:3, ani4_crop.mtx:3)."""
    import os

    here = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "matrices", name)
    if os.path.exists(here):
        return here
    raise FileNotFoundError(f"test matrix {name} not found in matrices/")
