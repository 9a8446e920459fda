"""Local preconditioners: port of ``schwarz_tpu/solvers/precond.py``.

Diagonal Jacobi, dense block-Jacobi (the diagonal blocks of the ELL
operator, inverted on the host at setup, applied as a batched block
product), ILU(0) on the operator's own pattern (applied as truncated
Neumann sweeps, never a substitution) and FSAI(0), the factorized sparse
approximate inverse ``M = G^T G ~= A^-1`` with G on the lower pattern of A
(Kolotilina-Yeremin), whose apply is two sparse products.

Every factor is built once on the host in numpy, with the JAX package's
arithmetic, so the builds agree with it bit for bit; the applies are torch
ops.  :func:`preconditioner` is the one dispatch on ``settings.precond``;
on the solver's DIA operator the banded factors go through
:func:`ell_to_dia` and their products are K1 (``ops/dia_kernel.py``) on
the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.config import Precond, Settings
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv, dia_spmv_chain
from schwarz_tpu_torch.ops.spmv import ell_spmv_batched
from schwarz_tpu_torch.utils.timing import span


def extract_diagonal(vals: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """diag[s, r] = A_s[r, r] from batched ELL (S, R, W)."""
    rows = np.arange(vals.shape[1])[None, :, None]
    return np.where(cols == rows, vals, 0).sum(axis=-1)


def jacobi_inverse(vals: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """1 / diag(A) in the dtype of ``vals``, with 1 where the diagonal is
    zero (padding rows)."""
    d = extract_diagonal(vals, cols)
    return np.where(np.abs(d) > 0, 1.0 / np.where(d != 0, d, 1), 1.0).astype(
        vals.dtype)


def extract_diag_blocks(vals: np.ndarray, cols: np.ndarray,
                        bs: int) -> np.ndarray:
    """Dense diagonal blocks (S, R//bs, bs, bs) of the batched ELL operator,
    in the dtype of ``vals``."""
    vals = np.asarray(vals)
    cols = np.asarray(cols, np.int64)
    S, R, W = vals.shape
    if R % bs:
        raise ValueError(f"block size {bs} must divide padded rows {R}")
    rows = np.broadcast_to(np.arange(R)[None, :, None], (S, R, W))
    same_block = (cols // bs) == (rows // bs)
    contrib = np.where(same_block, vals, 0)
    # entries outside the block add a zero on the diagonal slot
    ci = np.where(same_block, cols % bs, rows % bs)
    s_idx = np.broadcast_to(np.arange(S)[:, None, None], (S, R, W))
    out = np.zeros((S, R // bs, bs, bs), dtype=vals.dtype)
    np.add.at(out, (s_idx, rows // bs, rows % bs, ci), contrib)
    return out


def block_jacobi_inverse(vals: np.ndarray, cols: np.ndarray,
                         bs: int) -> np.ndarray:
    """Inverses of the diagonal blocks, on the host in the dtype of
    ``vals``; a row with no entries in its block gets a one on its
    diagonal, so padded blocks stay invertible."""
    blocks = extract_diag_blocks(vals, cols, bs)
    absent = np.all(blocks == 0.0, axis=-1, keepdims=True)
    return np.linalg.inv(blocks + absent * np.eye(bs, dtype=blocks.dtype))


def build_fsai(vals, cols):
    """FSAI(0) factors of a batched ELL operator (host numpy, setup time).

    For every row i with lower pattern ``J = {j : A[i,j] != 0, j <= i}``,
    solve ``A[J,J] g = e_i`` and scale ``g /= sqrt(g_i)``; then
    ``G A G^T ~= I`` and ``M = G^T G`` is an SPD approximate inverse.
    Returns ``(gl_vals, gl_cols, gu_vals, gu_cols)`` float64/int64 numpy:
    G in batched ELL on the lower pattern and G^T on the upper pattern
    (padded entries carry value 0 with column == row).  Rows with no true
    entries (padding rows of the batched layout) get an identity G row.
    """
    vals = np.asarray(vals, np.float64)
    cols = np.asarray(cols, np.int64)
    S, R, W = vals.shape
    rows = np.arange(R, dtype=np.int64)
    real = vals != 0
    lower = real & (cols <= rows[None, :, None])
    wl = max(int(lower.sum(axis=2).max()), 1)

    # sort the lower entries first within each row, pad with -1
    key = np.where(lower, cols, np.iinfo(np.int64).max)
    order = np.argsort(key, axis=2, kind="stable")
    cols_sorted = np.take_along_axis(cols, order, 2)
    lower_sorted = np.take_along_axis(lower, order, 2)
    gl_cols = np.where(lower_sorted, cols_sorted, -1)[:, :, :wl]

    gl_vals = np.zeros((S, R, wl), np.float64)
    eye = np.eye(wl)[None]
    for s in range(S):
        J = gl_cols[s]                          # (R, wl), -1 = pad
        padm = J < 0
        Jc = np.where(padm, 0, J)
        vw = vals[s][Jc]                        # (R, wl, W)
        cw = cols[s][Jc]                        # (R, wl, W)
        mw = real[s][Jc]
        # AJJ[i, p, q] = A[J_p, J_q]
        match = mw[:, :, None, :] & (cw[:, :, None, :] == Jc[:, None, :, None])
        AJJ = (vw[:, :, None, :] * match).sum(-1)
        pp = padm[:, :, None] | padm[:, None, :]
        AJJ = np.where(pp, eye, AJJ)
        e = (J == rows[:, None]).astype(np.float64)
        try:
            g = np.linalg.solve(AJJ, e[..., None])[..., 0]
        except np.linalg.LinAlgError:
            # a singular lower principal submatrix: pseudo-inverse rows; the
            # gi > 0 guard below turns unusable rows into identity rows
            g = (np.linalg.pinv(AJJ) @ e[..., None])[..., 0]
        gi = (g * e).sum(1)
        ok = gi > 0
        g = np.where(ok[:, None],
                     g / np.sqrt(np.where(ok, gi, 1.0))[:, None], 0.0)
        g = np.where(padm, 0.0, g)
        gl_vals[s] = g
        # rows with no true entries: identity G row keeps M nonsingular
        empty = ~ok
        if empty.any():
            gl_cols[s][empty, 0] = rows[empty]
            gl_vals[s][empty, 0] = 1.0
            gl_vals[s][empty, 1:] = 0.0

    # G^T in ELL: entry (i, J[i,p]) of G becomes (J[i,p], i) of G^T
    srows = np.broadcast_to(rows[None, :, None], (S, R, wl))
    keep = gl_cols >= 0
    wu = 1
    buckets = []
    for s in range(S):
        tr = gl_cols[s][keep[s]]
        tc = srows[s][keep[s]]
        tv = gl_vals[s][keep[s]]
        o = np.lexsort((tc, tr))
        tr, tc, tv = tr[o], tc[o], tv[o]
        cnt = np.bincount(tr, minlength=R)
        wu = max(wu, int(cnt.max()) if cnt.size else 1)
        buckets.append((tr, tc, tv, cnt))
    gu_cols = np.broadcast_to(rows[None, :, None], (S, R, wu)).copy()
    gu_vals = np.zeros((S, R, wu), np.float64)
    for s, (tr, tc, tv, cnt) in enumerate(buckets):
        slot = np.arange(tr.size) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
        )
        gu_cols[s][tr, slot] = tc
        gu_vals[s][tr, slot] = tv
    # device-ELL padding convention: value 0 at column == row
    gl_cols = np.where(gl_cols < 0, np.broadcast_to(rows[None, :, None],
                                                    gl_cols.shape), gl_cols)
    return gl_vals, gl_cols, gu_vals, gu_cols


def build_ilu0(vals, cols):
    """ILU(0) factors on A's own sparsity pattern (host numpy, setup time).

    The reference's ParILU role (solve.cpp:490-556).  Standard IKJ ILU(0):
    for each row i and each lower entry (i, k) in ascending k,
    ``l_ik = a_ik / u_kk`` then ``a_ij -= l_ik * u_kj`` over the row's
    retained pattern.  Zero pivots are skipped (the row degrades toward
    Jacobi rather than breaking down).

    Returns batched ELL numpy arrays
    ``(l_vals, l_cols, u_vals, u_cols, udiag)``: L strictly lower with unit
    diagonal implied, U strictly upper, and the U diagonal separately
    (padding entries carry value 0 at column == row).
    """
    vals = np.asarray(vals, np.float64)
    cols = np.asarray(cols, np.int64)
    S, R, W = vals.shape
    rows = np.arange(R, dtype=np.int64)
    l_vals = np.zeros((S, R, W), np.float64)
    l_cols = np.broadcast_to(rows[None, :, None], (S, R, W)).copy()
    u_vals = np.zeros((S, R, W), np.float64)
    u_cols = np.broadcast_to(rows[None, :, None], (S, R, W)).copy()
    udiag = np.ones((S, R), np.float64)
    tiny = 1e-300
    for s in range(S):
        row = []           # row -> dict col -> val
        for i in range(R):
            d = {}
            for w in range(W):
                v = vals[s, i, w]
                if v != 0.0:
                    c = int(cols[s, i, w])
                    d[c] = d.get(c, 0.0) + float(v)
            row.append(d)
        for i in range(R):
            di = row[i]
            for k in sorted(c for c in di if c < i):
                ukk = row[k].get(k, 0.0)
                if abs(ukk) <= tiny:
                    di[k] = 0.0     # skipped pivot: degrade, don't break
                    continue
                lik = di[k] / ukk
                di[k] = lik
                for j, ukj in row[k].items():
                    if j > k and j in di:
                        di[j] -= lik * ukj
        for i in range(R):
            wl = wu = 0
            for c in sorted(row[i]):
                v = row[i][c]
                if c < i:
                    l_cols[s, i, wl] = c
                    l_vals[s, i, wl] = v
                    wl += 1
                elif c == i:
                    udiag[s, i] = v if abs(v) > tiny else 1.0
                else:
                    u_cols[s, i, wu] = c
                    u_vals[s, i, wu] = v
                    wu += 1
    return l_vals, l_cols, u_vals, u_cols, udiag


def ilu_apply(l_mul, u_mul, udiag_inv, r, sweeps: int) -> torch.Tensor:
    """z ~= U^-1 L^-1 r with each triangular inverse expanded to ``sweeps``
    Jacobi iterations (truncated Neumann series; exact as sweeps -> R since
    the strict factors are nilpotent); ``l_mul`` and ``u_mul`` are the
    strict factors' products, sparse products only."""
    y = r
    for _ in range(sweeps):
        y = r - l_mul(y)
    x = udiag_inv * y
    for _ in range(sweeps):
        x = udiag_inv * (y - u_mul(x))
    return x


def ell_to_dia(vals, cols):
    """Exact batched ELL -> DIA conversion (host; for the factor applies).

    Any true entry lands on its (col - row) diagonal; padded zeros vanish.
    Returns ``(offsets, dia_vals)`` with dia_vals (S, K, R).
    """
    vals = np.asarray(vals)
    cols = np.asarray(cols, np.int64)
    S, R, W = vals.shape
    rows = np.arange(R, dtype=np.int64)[None, :, None]
    real = vals != 0
    d = cols - rows
    diffs = np.unique(d[real]) if real.any() else np.zeros(1, np.int64)
    offsets = tuple(int(o) for o in diffs)
    dia = np.zeros((S, len(offsets), R), vals.dtype)
    for k, o in enumerate(offsets):
        m = real & (d == o)
        dia[:, k, :] = (vals * m).sum(axis=2)
    return offsets, dia


def preconditioner(settings: Settings, pv: np.ndarray, cols: np.ndarray,
                   pdtype, put: Callable[..., Dict[str, torch.Tensor]],
                   dia_offsets: Optional[Tuple[int, ...]] = None):
    """``(apply, offsets)`` of ``settings.precond`` on the ELL operator
    ``pv`` / ``cols`` (S, R, W): the factors are built on the host and go in
    ``pdtype`` through ``put`` (entries under the JAX package's plan keys,
    ``ras.py:965-1060``, to device tensors); ``apply`` is ``z = M^-1 r`` or
    None, ``offsets`` the ILU(0) / FSAI(0) factors' diagonals.  Given the
    operator's ``dia_offsets`` those factors go to DIA form (K1 on the
    card), FSAI's pattern cut to the offsets to keep them banded."""
    s = settings
    if s.precond == Precond.none:
        return None, None
    if s.precond == Precond.jacobi:
        dinv = put(precond_dinv=jacobi_inverse(pv, cols).astype(pdtype))[
            "precond_dinv"]
        return (lambda r: dinv * r), None
    if s.precond == Precond.block_jacobi:
        bs = s.block_jacobi_block_size
        inv_blocks = put(precond_blockinv=block_jacobi_inverse(
            pv, cols, bs).astype(pdtype))["precond_blockinv"]

        def apply_block_jacobi(r):
            S, R = r.shape
            zb = torch.einsum("sbij,sbj->sbi", inv_blocks,
                              r.reshape(S, R // bs, bs))
            return zb.reshape(S, R)

        return apply_block_jacobi, None
    if s.precond == Precond.ilu:
        sweeps = s.ilu_sweeps
        lv, lc, uv, uc, ud = build_ilu0(pv, cols)
        udinv = put(ilu_udinv=(1.0 / ud).astype(pdtype))["ilu_udinv"]
        if dia_offsets is None:
            lv, lc, uv, uc = put(ilu_l_vals=lv.astype(pdtype), ilu_l_cols=lc,
                                 ilu_u_vals=uv.astype(pdtype),
                                 ilu_u_cols=uc).values()
            l_mul = functools.partial(ell_spmv_batched, lv, lc)
            u_mul = functools.partial(ell_spmv_batched, uv, uc)
            offsets = None
        else:
            (lo, ld), (uo, udia) = ell_to_dia(lv, lc), ell_to_dia(uv, uc)
            ld, udia = put(ilu_l_dia=ld.astype(pdtype),
                           ilu_u_dia=udia.astype(pdtype)).values()
            l_mul = functools.partial(dia_spmv, lo, ld)
            u_mul = functools.partial(dia_spmv, uo, udia)
            offsets = (lo, uo)
        return (lambda r: ilu_apply(l_mul, u_mul, udinv, r, sweeps)), offsets
    if s.precond == Precond.fsai:
        with span("fsai"):
            if dia_offsets is not None:
                rows = np.arange(pv.shape[1])[None, :, None]
                on_dia = np.isin(np.asarray(cols, np.int64) - rows,
                                 np.asarray(dia_offsets))
                pv = np.where(on_dia, pv, 0.0)
            glv, glc, guv, guc = build_fsai(pv, cols)
            if dia_offsets is None:
                host = dict(fsai_gl_vals=glv.astype(pdtype), fsai_gl_cols=glc,
                            fsai_gu_vals=guv.astype(pdtype), fsai_gu_cols=guc)
            else:
                (go, gd), (uo, ud) = ell_to_dia(glv, glc), ell_to_dia(guv, guc)
                host = dict(fsai_gl_dia=gd.astype(pdtype),
                            fsai_gu_dia=ud.astype(pdtype))
        if dia_offsets is None:
            gv, gc, uv, uc = put(**host).values()
            # M r = G^T (G r): two sparse products, no substitution
            return (lambda r: ell_spmv_batched(
                uv, uc, ell_spmv_batched(gv, gc, r))), None
        gd, ud = put(**host).values()
        # one chained launch of K1 on the card
        return (lambda r: dia_spmv_chain(go, gd, uo, ud, r)), (go, uo)
    raise ValueError(f"unknown preconditioner {settings.precond}")


def make_preconditioner(
    settings: Settings, vals: torch.Tensor, cols: torch.Tensor
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The apply function ``z = M^{-1} r`` (batched (S, R) -> (S, R)) of
    ``settings.precond`` for the ELL operator ``vals``/``cols`` (S, R, W),
    built on the host and kept on the operator's device."""
    dev = vals.device

    def put(**entries):
        return {k: torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for k, a in entries.items()}

    v = vals.cpu().numpy()
    return preconditioner(settings, v, cols.cpu().numpy(), v.dtype, put)[0]
