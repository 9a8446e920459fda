"""Batched dense direct local solvers: the port of ``schwarz_tpu/solvers/
direct.py``.

The reference's sparse direct path (CHOLMOD LL^T, solve.cpp:92-143; UMFPACK
LU, solve.cpp:144-173; the Ginkgo triangular solves, solve.cpp:281-455,
711-720) becomes a dense factorization of every subdomain's local matrix,
batched over the subdomain axis.  The factorization runs once at setup; only
the applies are on the iteration's path.  The JAX package computes all of
this outside any Pallas kernel, so here they are ``torch.linalg`` and
batched ``torch.matmul`` calls.

The products never run in TF32 (:func:`_full_precision`): a direct solve
must deliver the factor's digits (the JAX package runs them at
``Precision.HIGHEST`` for the same reason); a caller that wants a
low-precision preconditioner lowers ``local_compute_dtype`` instead.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_precision():
    """float32 products in full float32 (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def densify(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(S, R, W) padded ELL -> (S, R, R) dense, duplicates summed (padding
    slots carry 0 on an in-range column); columns >= R are dropped."""
    S, R, W = vals.shape
    cols = cols.to(torch.int64)
    in_range = cols < R
    idx = (torch.arange(R, device=vals.device)[None, :, None] * R
           + torch.where(in_range, cols, 0))
    dense = torch.zeros((S, R * R), dtype=vals.dtype, device=vals.device)
    dense.scatter_add_(1, idx.reshape(S, -1),
                       torch.where(in_range, vals, 0.0).reshape(S, -1))
    return dense.reshape(S, R, R)


def cholesky_factor(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Batched dense Cholesky of the local matrices: (S, R, W) ELL ->
    (S, R, R) lower factor.  Padded rows carry identity diagonals, so the
    factor exists whenever each true local matrix is SPD."""
    return torch.linalg.cholesky(densify(vals, cols))


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b by two batched triangular solves."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0]


def cholesky_inverse(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse from the factor, ``A^-1 = L^-T L^-1``, as the JAX
    package computes it: two triangular solves against I, then one batched
    product.  Setup cost; every apply is then one batched matrix-vector
    product (:func:`inverse_apply`)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    with _full_precision():
        return torch.matmul(Linv.mT, Linv)


def inverse_apply(Ainv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b as one batched matrix-vector product."""
    with _full_precision():
        return torch.matmul(Ainv, b[..., None])[..., 0]


def pick_trisolve_block(R: int) -> int:
    """Block size of the blocked substitution: the largest of 512, 384, 256
    and 128 that divides ``R``, else any divisor >= 8, else ``R`` (the JAX
    package's choice, kept so that both packages cut the same blocks)."""
    for blk in (512, 384, 256, 128):
        if R % blk == 0:
            return blk
    for blk in range(min(R, 256), 7, -1):
        if R % blk == 0:
            return blk
    return R


def block_diag_inverses(L: torch.Tensor, block: int) -> torch.Tensor:
    """(S, R/block, block, block): the inverses of the diagonal blocks of
    the lower factor ``L`` (the setup of ``direct_apply='blocked'``)."""
    S, R, _ = L.shape
    if R % block:
        raise ValueError(f"R={R} not a multiple of block={block}")
    nb = R // block
    blocks = torch.stack(
        [L[:, i * block:(i + 1) * block, i * block:(i + 1) * block]
         for i in range(nb)], dim=1)
    eye = torch.eye(block, dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(blocks, eye.expand(blocks.shape),
                                         upper=False)


def _panel(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(S, r, k) x (S, k) -> (S, r)."""
    return torch.matmul(M, v[..., None])[..., 0]


def blocked_cholesky_solve(L: torch.Tensor, Dinv: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b by blocked forward and back substitution: each of the
    ``nb`` steps is one panel product against the solved blocks and one
    product with the pre-inverted diagonal block (``Dinv`` from
    :func:`block_diag_inverses`).  Keeps the factor's conditioning, unlike
    the explicit inverse."""
    nb, block = Dinv.shape[1], Dinv.shape[2]
    with _full_precision():
        y = torch.zeros_like(b)
        for i in range(nb):
            lo, hi = i * block, (i + 1) * block
            rhs = b[:, lo:hi]
            if i:
                rhs = rhs - _panel(L[:, lo:hi, :lo], y[:, :lo])
            y[:, lo:hi] = _panel(Dinv[:, i], rhs)
        # back sweep: L^T x = y, the panels read from L's strictly lower part
        x = torch.zeros_like(b)
        for i in range(nb - 1, -1, -1):
            lo, hi = i * block, (i + 1) * block
            rhs = y[:, lo:hi]
            if i < nb - 1:
                rhs = rhs - _panel(L[:, hi:, lo:hi].mT, x[:, hi:])
            x[:, lo:hi] = _panel(Dinv[:, i].mT, rhs)
    return x


def lu_factor(vals: torch.Tensor, cols: torch.Tensor):
    """Batched dense LU with partial pivoting: ``(lu, pivots)``, pivots
    1-based as LAPACK gives them (the JAX package's are 0-based)."""
    return torch.linalg.lu_factor(densify(vals, cols))


def lu_solve(factors, b: torch.Tensor) -> torch.Tensor:
    lu, piv = factors
    return torch.linalg.lu_solve(lu, piv, b[..., None])[..., 0]
