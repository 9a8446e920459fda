"""The two-level coarse correction of the synchronous solver: the port of
``schwarz_tpu/ras.py:77-250`` (``_coarse_cg``, ``_coarse_correct``,
``_spectral_coarse_basis``) and of the coarse part of
``RASolver._build_plan`` (:681-760).

The coarse space is either q equal contiguous aggregates of interior slots
per subdomain (q = 1 is Nicolaides' piecewise-constant space) or q
Neumann-block eigenvectors per subdomain (``core/coarse.py``).  Its
Galerkin matrix ``A_c`` is built on the host in float64; the loop solves
with its inverse (``coarse_solver='dense'``) or with CG on ``A_c``
(``'cg'``).  Restriction, prolongation and the inverse's product are plain
batched products (``torch.einsum`` / ``torch.matmul``), as the JAX package
computes them outside any Pallas kernel.  Under mixed-precision locals the
basis and the inverse are stored in the inner dtype, as the JAX package
stores them, so the numbers agree.

Across processes (a :class:`~schwarz_tpu_torch.parallel.mesh.Mesh` of
several) the coarse residual is gathered once a solve
(``schwarz_tpu/ras.py:161``).  Each process holds its row block ``(Sl q,
S q)`` of the dense inverse, as each JAX device does (:95), and applies it
to the gathered residual.  ``A_c`` stays whole on every process, which
runs the single-process CG on it and keeps its own rows: the JAX
package's row-sharded CG (:90-143) makes three collectives a CG
iteration, each a round trip through the host, against this one a solve,
for the (S q)^2 entries every process already holds on the host.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from schwarz_tpu_torch.utils.timing import HOST_READS, count, spanned


def _above(rn: torch.Tensor, bound: torch.Tensor) -> bool:
    count(HOST_READS, "coarse_cg.active")
    return bool(rn > bound)


def coarse_cg(Am: torch.Tensor, r_c: torch.Tensor) -> torch.Tensor:
    """CG on the Galerkin coarse system ``Am c = r_c`` (``coarse_solver=
    'cg'``): tolerance 50 eps of the matrix's dtype, relative to a residual
    normalized to unit norm (CG is scale-equivariant, and the eps-floored
    coefficient guards would otherwise clamp scale-dependent quantities),
    at most the coarse dimension's iterations."""
    dim = Am.shape[1]
    r_in = r_c.reshape(-1)
    fin = torch.finfo(Am.dtype)
    tol2 = (50.0 * fin.eps) ** 2
    rin_n = torch.sum(r_in * r_in)
    scale = torch.sqrt(torch.clamp(rin_n, min=fin.tiny))
    r = r_in / scale
    rn = torch.sum(r * r)
    rn0 = rn
    x = torch.zeros_like(r)
    p = r
    it = 0
    while it < dim and _above(rn, tol2 * rn0):
        ap = Am @ p
        pap = torch.sum(p * ap)
        alpha = torch.where(pap > 0, rn / torch.clamp(pap, min=fin.eps),
                            torch.zeros_like(pap))
        x = x + alpha * p
        r = r - alpha * ap
        rn_new = torch.sum(r * r)
        beta = torch.where(rn > 0, rn_new / torch.clamp(rn, min=fin.eps),
                           torch.zeros_like(rn))
        p = r + beta * p
        rn = rn_new
        it += 1
    x = torch.where(rin_n > 0, x * scale, torch.zeros_like(x))
    return x.reshape(r_c.shape)


@spanned("coarse_correction")
def coarse_correct(plan, r_int_win: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Coarse correction field (S, R_int) from the interior residual
    ``r_int_win`` (zero on the padding slots, so partially padded
    aggregates restrict correctly); under a ``mesh`` of several processes,
    the process's rows."""
    shard = plan.get("coarse_inv", plan.get("coarse_mat"))
    S, R_int = r_int_win.shape
    q = shard.shape[1] // (S * (1 if mesh is None else mesh.num_processes))

    def solve_c(r_c):
        if mesh is not None:
            r_c = mesh.all_gather(r_c)                 # (S_all, q)
        if "coarse_mat" in plan:
            c = coarse_cg(plan["coarse_mat"], r_c)
            return c if mesh is None else c[mesh.block(c.shape[0])]
        # the JAX package's type promotion: a float32 inverse applied to a
        # float64 coarse residual computes in float64
        dt = torch.promote_types(shard.dtype, r_c.dtype)
        return (shard.to(dt) @ r_c.reshape(-1).to(dt)).reshape(S, q)

    if "coarse_basis" in plan:
        basis = plan["coarse_basis"]               # (S, q, R_int)
        r_c = torch.einsum("sqr,sr->sq", basis, r_int_win.to(basis.dtype))
        c = solve_c(r_c.to(shard.dtype)).to(basis.dtype)
        return torch.einsum("sq,sqr->sr", c, basis).to(r_int_win.dtype)
    w = R_int // q
    r_c = torch.sum(r_int_win.reshape(S, q, w), dim=2)
    c = solve_c(r_c)
    return c[:, :, None].expand(S, q, w).reshape(S, R_int)


def spectral_coarse_basis(dec, q: int, r_int: int):
    """Per subdomain the ``q`` lowest eigenvectors of the algebraic Neumann
    block (``core/coarse.py``), zero-padded to (S, q, r_int), and the dense
    float64 Galerkin matrix ``V^T A V`` (S q, S q).  Both are cached beside
    the eigenvectors under ``SCHWARZ_TPU_COARSE_CACHE`` in the JAX
    package's file format."""
    import scipy.sparse as sp

    from schwarz_tpu_torch.core.coarse import (_coarse_cache_path,
                                               build_prolongator,
                                               neumann_spectral_vectors)

    gm = dec.global_matrix
    S = dec.meta.num_subdomains
    A = sp.csr_matrix((gm.values, gm.col_idxs, gm.row_ptrs),
                      shape=(gm.n, gm.n))
    cp = _coarse_cache_path(A, dec.first_row[:S + 1], q)
    acp = None
    if cp is not None:
        d, fn = os.path.split(cp)
        acp = os.path.join(d, fn.replace(
            "coarse_", f"coarse_galerkin{r_int}_", 1))
    if acp is not None and os.path.exists(acp):
        with np.load(acp) as z:
            return z["basis"], z["A_c"]
    vectors = neumann_spectral_vectors(A, dec.first_row[:S + 1], q)
    basis = np.zeros((S, q, r_int), dtype=np.float64)
    for sd in range(S):
        vecs = vectors[sd]
        if vecs.size:
            basis[sd, :vecs.shape[1], :vecs.shape[0]] = vecs.T
    V = build_prolongator(vectors, dec.first_row[:S + 1], gm.n, q)
    A_c = np.asarray((V.T @ (A @ V)).todense(), dtype=np.float64)
    if acp is not None:
        # the suffix must end in .npz, or np.savez appends one and the
        # os.replace moves the empty temporary file instead
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(acp), suffix=".npz")
        os.close(fd)
        np.savez_compressed(tmp, basis=basis, A_c=A_c)
        os.replace(tmp, acp)   # atomic: concurrent writers race safely
    return basis, A_c


def coarse_arrays(dec, settings, dtype: np.dtype,
                  inner_dtype: Optional[np.dtype]) -> Dict[str, np.ndarray]:
    """The coarse entries of the solver's plan, on the host: the spectral
    basis (in the inner dtype) and either the dense inverse (in the inner
    dtype) or the Galerkin matrix for CG (in the outer dtype)."""
    s = settings
    q = max(1, int(s.coarse_aggregates))
    R_int = dec.meta.max_interior
    gm = dec.global_matrix
    S = dec.meta.num_subdomains
    out = {}
    if s.coarse_space == "aggregates":
        if R_int % q:
            raise ValueError(
                f"coarse_aggregates ({q}) must divide the padded interior "
                f"width ({R_int}); pick a power-of-two divisor or adjust "
                "row_pad_multiple")
        w = R_int // q
        rows_of = np.repeat(np.arange(gm.n, dtype=np.int64),
                            np.diff(gm.row_ptrs))
        po = np.searchsorted(dec.first_row, rows_of, side="right") - 1
        qo = np.searchsorted(dec.first_row, gm.col_idxs, side="right") - 1
        cr = po * q + (rows_of - dec.first_row[po]) // w
        cc = qo * q + (gm.col_idxs - dec.first_row[qo]) // w
        A_c = np.zeros((S * q, S * q), dtype=np.float64)
        np.add.at(A_c, (cr, cc), gm.values)
    elif s.coarse_space == "spectral":
        basis, A_c = spectral_coarse_basis(dec, q, R_int)
        out["coarse_basis"] = basis.astype(inner_dtype or dtype)
    else:
        raise ValueError(
            f"coarse_space must be 'aggregates' or 'spectral', got "
            f"{s.coarse_space!r}")
    # coarse DOFs with no support (padding-only aggregates, or zero basis
    # columns where q exceeds the interior size): identity rows keep A_c
    # nonsingular, and their corrections are exactly zero
    empty = ~A_c.any(axis=1)
    A_c[empty, empty] = 1.0
    if s.coarse_solver == "cg":
        if s.non_symmetric_matrix:
            raise ValueError(
                "coarse_solver='cg' requires a symmetric operator (the "
                "Galerkin coarse matrix inherits A's non-symmetry and CG "
                "would silently stagnate through its full iteration cap); "
                "use coarse_solver='dense' for non-symmetric problems")
        out["coarse_mat"] = A_c.astype(dtype)
    elif s.coarse_solver == "dense":
        try:
            inv = np.linalg.inv(A_c)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(A_c)
        out["coarse_inv"] = inv.astype(inner_dtype or dtype)
    else:
        raise ValueError(
            f"coarse_solver must be 'dense' or 'cg', got "
            f"{s.coarse_solver!r}")
    return out
