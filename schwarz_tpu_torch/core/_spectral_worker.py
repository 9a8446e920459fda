"""Standalone subprocess worker for the per-subdomain spectral eigensolves.

The port's copy of ``schwarz_tpu/core/_spectral_worker.py``.  Executed BY
PATH (``python .../_spectral_worker.py in.pkl out.pkl``), never imported as
part of the package: it stays numpy/scipy-only, so a worker process pays
neither the package's nor torch's import cost.

Input pickle: list of payload tuples
``(data, indices, indptr, n_s, k, tol)``: the symmetrized Neumann block in
raw CSC arrays (see ``coarse.neumann_spectral_vectors``).
Output pickle: list of (n_s, k) float64 eigenvector arrays, same order.
"""

import pickle
import sys

import numpy as np


def solve_block(payload):
    data, indices, indptr, n_s, k, tol = payload
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    Asym = sp.csc_matrix((data, indices, indptr), shape=(n_s, n_s))
    # the Neumann block is singular (constant near-kernel): shift-invert
    # just below zero keeps the factorization definite while targeting
    # the lowest modes
    scale = float(np.abs(Asym.diagonal()).max()) or 1.0
    # deterministic Lanczos start: ARPACK's default v0 is random, which
    # rotates degenerate eigenspaces between calls, so two otherwise
    # identical setups would build different coarse spaces
    v0 = np.random.default_rng(12345).standard_normal(n_s)
    try:
        _, vecs = spla.eigsh(Asym, k=k, sigma=-1e-8 * scale,
                             which="LM", v0=v0, tol=tol)
    except Exception:
        _, v = np.linalg.eigh(Asym.toarray())
        vecs = v[:, :k]
    return np.asarray(vecs, np.float64)


def main(in_path, out_path):
    with open(in_path, "rb") as f:
        payloads = pickle.load(f)
    results = [solve_block(p) for p in payloads]
    with open(out_path, "wb") as f:
        pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
