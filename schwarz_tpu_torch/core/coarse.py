"""Host-side spectral coarse-space construction (GenEO-style).

The port of ``schwarz_tpu/core/coarse.py``, numpy and scipy only.  Shared
by the synchronous two-level solver (``ras.RASolver``, which ships the basis
to the device as a padded batched array) and the free-running
iterative refinement (``ops.async_ras.iterative_refinement_run``,
which applies the coarse correction on the host between kernel launches:
two-level asynchronous Schwarz, coarse solves at the restart
synchronization points, barrier-free one-level iteration in between).  The
cache files (:func:`_coarse_cache_path`) have the JAX package's names and
contents, so either package reads the other's.

The construction is fully algebraic.  Per subdomain (a contiguous row range
of the matrix), take the ``q`` lowest eigenvectors of the NEUMANN block:
the diagonal block ``A_ss`` with the exterior rowsums restored on the
diagonal, which undoes the Dirichlet clamping ``A_ss`` carries at subdomain
interfaces.  Plain Dirichlet-block eigenvectors vanish at the interfaces —
exactly where the Schwarz error concentrates — and measure WORSE than
contiguous index aggregates; the Neumann modes are interface-free
near-kernel vectors (the lowest is the constant, so q = 1 recovers the
span of Nicolaides' piecewise-constant space).  Cf. Spillane et al. (GenEO)
and Neumann-Neumann coarse spaces.  Beyond the reference, which is strictly
one-level (it has no coarse space at all).
"""

from __future__ import annotations

import numpy as np

from schwarz_tpu_torch.utils.timing import spanned


# Lanczos residual tolerance for the per-subdomain eigensolves.  The coarse
# space only needs to SPAN the near-kernel, not resolve eigenpairs to machine
# precision: at 1e-4 the principal angles to the exact q=64 basis of a 65k
# Neumann block measure cos >= 1 - 3e-9 while ARPACK converges ~1.5x faster.
_EIGSH_TOL = 1e-4

# Estimated Lanczos work (nnz * q) below which a block solves fast enough
# serially that a spawned worker's interpreter and scipy start-up would
# dominate.  The JAX package's value, kept so that both packages take the
# same branch (pooled or in-process) for the same block: a 16k-row Neumann
# block at q=32 is 2.6e6 units, so the 512^2 flagship's 16 blocks go to
# the pool.
_PARALLEL_MIN_WORK = 1.5e6

# generous per-worker wall clock; a hung worker triggers the serial fallback
# instead of stalling coarse-space setup forever
_WORKER_TIMEOUT_S = 900.0


def _solve_blocks_subprocess(payloads, n_workers):
    """Run the Lanczos payloads across ``n_workers`` subprocesses.

    Workers execute this package's ``_spectral_worker.py`` BY PATH: a
    numpy/scipy-only script, so they import neither torch nor the package,
    and no ``__main__`` re-import happens as with multiprocessing's spawn
    (which breaks under REPL / stdin parents).  Payloads are dealt
    round-robin by descending size so the per-worker loads balance.
    Returns results in input order, or None if any worker failed (the
    caller falls back to serial).
    """
    import os
    import pickle
    import subprocess
    import sys
    import tempfile

    script = os.path.join(os.path.dirname(__file__), "_spectral_worker.py")
    order = sorted(range(len(payloads)),
                   key=lambda i: -int(payloads[i][3]))
    groups = [[] for _ in range(n_workers)]
    for pos, idx in enumerate(order):
        groups[pos % n_workers].append(idx)
    env = dict(os.environ)
    # one BLAS thread per worker: the workers ARE the parallelism — letting
    # each one spin a full OpenBLAS pool oversubscribes the cores
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        env[var] = "1"
    results = [None] * len(payloads)
    with tempfile.TemporaryDirectory() as td:
        procs = []
        ok = True
        try:
            for g, idxs in enumerate(groups):
                if not idxs:
                    continue
                in_p = os.path.join(td, f"in{g}.pkl")
                out_p = os.path.join(td, f"out{g}.pkl")
                err_p = os.path.join(td, f"err{g}.log")
                with open(in_p, "wb") as f:
                    pickle.dump([payloads[i] for i in idxs], f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                with open(err_p, "wb") as errf:
                    procs.append((idxs, out_p, err_p, subprocess.Popen(
                        [sys.executable, script, in_p, out_p], env=env,
                        stdout=subprocess.DEVNULL, stderr=errf,
                    )))
            for idxs, out_p, err_p, proc in procs:
                try:
                    rc = proc.wait(timeout=_WORKER_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    ok = False
                    continue        # killed in the finally; serial fallback
                if rc != 0 or not os.path.exists(out_p):
                    ok = False
                    try:
                        with open(err_p, "rb") as f:
                            tail = f.read()[-2000:].decode(errors="replace")
                    except OSError:
                        tail = "<no stderr captured>"
                    print(
                        f"spectral worker rc={rc}; falling back to serial."
                        f" stderr tail:\n{tail}", file=sys.stderr,
                    )
                    continue
                with open(out_p, "rb") as f:
                    for i, vecs in zip(idxs, pickle.load(f)):
                        results[i] = vecs
        finally:
            # an exception (or a timed-out sibling) must not leak workers
            for entry in procs:
                proc = entry[-1]
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return results if ok and all(r is not None for r in results) else None


def _spectral_block_worker(payload):
    """Serial in-process path: same math as the subprocess workers (the
    worker module is numpy/scipy-only, safe to import in-process)."""
    from schwarz_tpu_torch.core import _spectral_worker

    return _spectral_worker.solve_block(payload)


def _coarse_cache_path(A, boundaries, q: int):
    """Content-addressed cache file for a (matrix, partition, q) basis, or
    None when caching is off.  Enabled by the ``SCHWARZ_TPU_COARSE_CACHE``
    env var (a directory); the key hashes the CSR arrays, the subdomain
    boundaries, q and the Lanczos tolerance, so any change misses.  The
    reference's analogue is factorize-once setup (solve.cpp:92-173);
    re-solves with new right-hand sides, or re-runs on the same operator,
    skip the eigensolves entirely.  The JAX package writes the same files
    under the same names."""
    import hashlib
    import os

    cache_dir = os.environ.get("SCHWARZ_TPU_COARSE_CACHE")
    if not cache_dir:
        return None
    h = hashlib.sha256()
    h.update(np.int64(A.shape[0]).tobytes())
    h.update(np.ascontiguousarray(A.indptr).tobytes())
    h.update(np.ascontiguousarray(A.indices).tobytes())
    h.update(np.ascontiguousarray(A.data).tobytes())
    h.update(np.ascontiguousarray(boundaries).tobytes())
    h.update(np.int64(q).tobytes())
    h.update(np.float64(_EIGSH_TOL).tobytes())
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"coarse_{h.hexdigest()[:32]}.npz")


@spanned("eigensolve")
def neumann_spectral_vectors(A, boundaries, q: int, workers=None):
    """Per-subdomain Neumann-block eigenvectors.

    ``A``: scipy sparse (n, n); ``boundaries``: (S+1,) row offsets of the
    contiguous subdomains; ``q``: vectors per subdomain (clipped to the
    subdomain size).  Returns a list of (n_s, k) float64 arrays.

    The per-subdomain eigensolves are independent, so blocks whose estimated
    Lanczos work (nnz * q) exceeds the worker-startup break-even run in a
    spawned process pool (``workers`` caps the pool; default = cpu count).
    Each block's solve is self-contained and deterministic given its BLAS
    environment; workers pin BLAS to one thread, so pooled results can
    differ from the in-process serial path at the last-bit level when the
    parent runs a multithreaded BLAS (same eigenspace, different rounding).

    With ``SCHWARZ_TPU_COARSE_CACHE=<dir>`` the whole basis is cached
    content-addressed on disk (see :func:`_coarse_cache_path`).
    """
    import scipy.sparse as sp

    A = A.tocsr()
    cache_path = _coarse_cache_path(A, boundaries, q)
    if cache_path is not None:
        import os

        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                return [z[f"v{sd}"] for sd in range(len(boundaries) - 1)]
    total_rowsum = np.asarray(A.sum(axis=1)).ravel()
    out = [None] * (len(boundaries) - 1)
    lanczos = []        # (sd, payload) for the pool-eligible blocks
    for sd in range(len(boundaries) - 1):
        lo, hi = int(boundaries[sd]), int(boundaries[sd + 1])
        n_s = hi - lo
        if n_s == 0:
            out[sd] = np.zeros((0, 0))
            continue
        k = min(q, n_s)
        Ass = A[lo:hi, lo:hi]
        local_rowsum = np.asarray(Ass.sum(axis=1)).ravel()
        ext = total_rowsum[lo:hi] - local_rowsum
        A_neu = Ass + sp.diags(ext)
        Asym = (0.5 * (A_neu + A_neu.T)).tocsc()
        if k >= n_s - 1 or n_s <= 64:
            _, v = np.linalg.eigh(Asym.toarray())
            out[sd] = np.asarray(v[:, :k], np.float64)
        else:
            lanczos.append((sd, (Asym.data, Asym.indices, Asym.indptr,
                                 n_s, k, _EIGSH_TOL)))
    big = [d.size * k for _, (d, _, _, _, k, _) in lanczos
           if d.size * k >= _PARALLEL_MIN_WORK]
    import os
    n_workers = min(len(big), workers or os.cpu_count() or 1)
    results = None
    if len(big) >= 2 and n_workers >= 2:
        results = _solve_blocks_subprocess([p for _, p in lanczos],
                                           n_workers)
    if results is not None:
        for (sd, _), vecs in zip(lanczos, results):
            out[sd] = vecs
    else:
        for sd, payload in lanczos:
            out[sd] = _spectral_block_worker(payload)
    if cache_path is not None:
        import os
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache_path),
                                   suffix=".npz")
        os.close(fd)
        np.savez_compressed(tmp, **{f"v{sd}": v for sd, v in enumerate(out)})
        os.replace(tmp, cache_path)   # atomic: concurrent writers race safely
    return out


def build_prolongator(vectors, boundaries, n: int, q: int):
    """Sparse prolongator V (n, S q) with per-subdomain block columns.

    Columns of subdomains smaller than ``q`` stay zero-padded (their
    Galerkin rows are fixed by the caller)."""
    import scipy.sparse as sp

    # the direct CSR build assumes sorted, non-overlapping row ranges;
    # violating callers must fail loudly, not get a malformed matrix
    assert np.all(np.diff(boundaries) >= 0), "boundaries must be sorted"

    # V is block-dense: row r of subdomain sd holds exactly k_sd entries at
    # columns sd*q .. sd*q+k_sd, values vecs[r-lo, :].  Build the CSR arrays
    # directly — a COO round-trip sorts all S*n_s*k entries (tens of
    # millions at the 1M-row flagship; measured 50 s -> <1 s).
    S = len(boundaries) - 1
    counts = np.zeros(n, np.int64)
    data_parts, idx_parts = [], []
    for sd in range(S):
        lo, hi = int(boundaries[sd]), int(boundaries[sd + 1])
        vecs = vectors[sd]
        k = vecs.shape[1] if vecs.size else 0
        if k == 0 or hi <= lo:
            continue
        counts[lo:hi] = k
        cols = np.arange(sd * q, sd * q + k, dtype=np.int64)
        idx_parts.append(np.tile(cols, hi - lo))
        data_parts.append(np.ascontiguousarray(vecs, np.float64).ravel())
    if not data_parts:
        return sp.csr_matrix((n, S * q))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return sp.csr_matrix(
        (np.concatenate(data_parts), np.concatenate(idx_parts), indptr),
        shape=(n, S * q),
    )


class HostCoarse:
    """Host-side coarse correction ``r -> V A_c^{-1} V^T r``.

    ``A_c = V^T A V`` is the Galerkin coarse matrix; zero (padded) coarse
    DOFs get identity rows, so their corrections are exactly zero.
    """

    def __init__(self, A, boundaries, q: int):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        boundaries = np.asarray(boundaries)
        vectors = neumann_spectral_vectors(A, boundaries, q)
        n = A.shape[0]
        self.V = build_prolongator(vectors, boundaries, n, q)
        A_c_s = (self.V.T @ (A @ self.V)).tocsc()
        dim = A_c_s.shape[0]
        empty = np.asarray(np.abs(A_c_s).sum(axis=1)).ravel() == 0
        if empty.any():
            # padded coarse DOFs: identity rows keep A_c nonsingular
            A_c_s = (A_c_s + sp.diags(empty.astype(np.float64))).tocsc()
        self.A_c = np.asarray(A_c_s.todense()) if dim <= 2048 else A_c_s
        if dim <= 2048:
            try:
                inv = np.linalg.inv(self.A_c)
            except np.linalg.LinAlgError:
                inv = np.linalg.pinv(self.A_c)
            self._solve_c = lambda rc: inv @ rc
        else:
            # large coarse spaces: the Galerkin matrix is block-sparse
            # (subdomain-neighbor coupling only) — a sparse LU scales where
            # a dense (qS)^2 inverse does not
            try:
                lu = spla.splu(A_c_s)
                self._solve_c = lu.solve
            except RuntimeError:
                # exactly-singular Galerkin matrix (floating/pure-Neumann
                # operator whose near-kernel sits in the coarse space):
                # pseudo-solve, matching the dense path's pinv fallback
                inv = np.linalg.pinv(np.asarray(A_c_s.todense()))
                self._solve_c = lambda rc: inv @ rc

    def solve(self, r: np.ndarray) -> np.ndarray:
        """The coarse correction for residual ``r`` (same length as rows
        of ``V``)."""
        rc = self.V.T @ np.asarray(r, np.float64)
        return self.V @ self._solve_c(rc)


def equal_strip_boundaries(n: int, num_subdomains: int) -> np.ndarray:
    """(S+1,) contiguous equal-strip row offsets — any partition of unity
    yields a valid coarse space, so callers whose kernel partition is not
    a contiguous permutation just use strips of the original ordering."""
    return np.linspace(0, n, num_subdomains + 1).astype(np.int64)
