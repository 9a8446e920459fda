"""The batched local solve of RAS (solve.cpp:666-792), its choices made
once at set-up: the inner operator (DIA + remainder or ELL, the
local-compute dtype, the O-RAS Robin term, ``inner_operator``), the
preconditioner (``solvers/precond.py``), K3 (``ops/fused_cg.py``) or the
batched CG / GMRES, or a dense Cholesky / LU factor applied by triangular
solves or an explicit inverse (``solvers/direct.py``), and the inner
budget.  Its device entries carry the JAX package's plan keys
(``schwarz_tpu/ras.py:560-1060``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from schwarz_tpu_torch.config import LocalSolver, Precond, Settings
from schwarz_tpu_torch.ops.dia import dia_ell_spmv, split_dia_ell
from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve, fused_cg_supported
from schwarz_tpu_torch.ops.spmv import ell_spmv_batched
from schwarz_tpu_torch.solvers import direct
from schwarz_tpu_torch.solvers.cg import cg_solve
from schwarz_tpu_torch.solvers.gmres import gmres_solve
from schwarz_tpu_torch.solvers.precond import preconditioner
from schwarz_tpu_torch.utils.timing import span, spanned

ITERATIVE = (LocalSolver.iterative_cg, LocalSolver.iterative_gmres)


@spanned("to_device")
def plan_from_numpy(arrays: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """Host plan arrays (decomposition fields, DIA split, run tables) as
    tensors on ``device``, with their dtypes kept."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def inner_dtype(settings: Settings) -> Optional[torch.dtype]:
    """The local-compute dtype where it differs from the outer one."""
    lc = settings.local_compute_dtype
    return None if lc in (None, settings.dtype) else getattr(torch, lc)


class LocalSolve:
    """Built once from the decomposition's local matrices, ``rows`` cutting
    a per-subdomain host array to this process's subdomains: ``plan`` holds
    the device entries, ``operator(inner)`` is the local operator's product,
    ``precond`` the preconditioner's apply, and a call is the solve."""

    def __init__(self, dec, settings: Settings, device: torch.device,
                 oras_c: float, rows: Callable[[np.ndarray], np.ndarray]):
        s = self.settings = settings
        S, R = dec.meta.num_subdomains, dec.meta.max_rows
        self.max_rows, self.device, self._rows = R, device, rows
        self.plan: Dict[str, torch.Tensor] = {}
        put = self._put
        dtype = np.dtype(s.dtype)
        self.lc_dtype = inner_dtype(s)
        lc_np = (None if self.lc_dtype is None
                 else np.dtype(s.local_compute_dtype))
        # DIA + remainder local operator; "auto" picks it on the card, as the
        # JAX package picks it on a TPU (the CPU keeps the ELL gathers)
        self.dia_offsets, self.dia_has_remainder = None, True
        if s.spmv_format == "dia" or (s.spmv_format == "auto"
                                      and device.type == "cuda"):
            hyb = split_dia_ell(dec.lmat_vals, dec.lmat_cols, dec.rows_count,
                                max_diags=s.dia_max_diags)
            dia_nnz = int((hyb.dia_vals != 0).sum())
            total_nnz = max(int((dec.lmat_vals != 0).sum()), 1)
            if s.spmv_format == "dia" or dia_nnz >= 0.5 * total_nnz:
                self.dia_offsets = hyb.offsets
                self.dia_has_remainder = bool(np.count_nonzero(hyb.rem_vals))
        dia = self.dia_offsets is not None
        # O-RAS: the local SOLVE operator's boundary rows gain c * sum |dropped
        # couplings| on the diagonal (the first col == row entry only);
        # residuals and the convergence check keep the true A.  The rhs
        # gains the matching c * D * trace in the solve, so the fixed point
        # is exactly A x = b (ras.py:624-680 of the JAX package)
        self.oras = oras_c != 0
        lv_solve, self._robin = dec.lmat_vals, None
        if self.oras:
            srows = np.broadcast_to(np.arange(S)[:, None], dec.iface_rows.shape)
            boost_pad = np.zeros((S, R + 1), dtype=np.float64)
            np.add.at(boost_pad, (srows, dec.iface_rows),
                      np.abs(dec.iface_vals).sum(axis=2))
            boost = oras_c * boost_pad[:, :R]
            self._robin, = put(oras_diag=boost.astype(dtype)).values()
            dmask = dec.lmat_cols == np.arange(R)[None, :, None]
            first = dmask & (np.cumsum(dmask, axis=2) == 1)
            lv_solve = dec.lmat_vals + boost[:, :, None] * first
        # the operator's copies (values, remainder values): the outer one is
        # the true A in the outer dtype, the inner one the local solve's, in
        # the local-compute dtype and with the Robin term under O-RAS
        if dia:
            vals, _, rem, _ = put(dia_vals=hyb.dia_vals.astype(dtype),
                                  rem_rows=hyb.rem_rows.astype(np.int64),
                                  rem_vals=hyb.rem_vals.astype(dtype),
                                  rem_cols=hyb.rem_cols.astype(np.int64)
                                  ).values()
            self._outer = (vals, rem)
            if lc_np is not None:
                vals, rem = put(dia_vals_lc=hyb.dia_vals.astype(lc_np),
                                rem_vals_lc=hyb.rem_vals.astype(lc_np)
                                ).values()
            if self.oras:
                dv = hyb.dia_vals.copy()
                dv[:, self.dia_offsets.index(0), :] += boost
                vals, = put(dia_vals_solve=dv.astype(dtype)).values()
                if lc_np is not None:
                    vals, = put(dia_vals_solve_lc=dv.astype(lc_np)).values()
        else:
            vals, _ = put(lmat_vals=dec.lmat_vals.astype(dtype),
                          lmat_cols=dec.lmat_cols.astype(np.int64)).values()
            self._outer, rem = (vals, None), None
            if lc_np is not None:
                vals, = put(lmat_vals_lc=dec.lmat_vals.astype(lc_np)).values()
            if self.oras:
                vals, = put(lmat_vals_solve=lv_solve.astype(dtype)).values()
                if lc_np is not None:
                    vals, = put(
                        lmat_vals_solve_lc=lv_solve.astype(lc_np)).values()
        self._inner = (vals, rem)
        self.precond = self.fsai_offsets = self.ilu_offsets = None
        if s.local_solver in ITERATIVE:
            self.precond, offsets = preconditioner(
                s, lv_solve.astype(dtype), dec.lmat_cols, lc_np or dtype,
                put, self.dia_offsets)
            if s.precond == Precond.fsai:
                self.fsai_offsets = offsets
            elif s.precond == Precond.ilu:
                self.ilu_offsets = offsets
        # K3, the whole local CG in one launch: a plan on the card takes it
        # whenever the gate holds; fused_local_cg asks for it on any device
        # and fails loudly with the recipe when the gate does not hold
        cg_local = s.local_solver == LocalSolver.iterative_cg
        gate = cg_local and dia and fused_cg_supported(
            S, R, len(self.dia_offsets), self.lc_dtype or s.value_dtype,
            self.dia_has_remainder, s.precond.value,
            factors_dia=self.fsai_offsets is not None)
        if s.fused_local_cg and not gate:
            if not cg_local:
                raise ValueError("fused_local_cg requires local_solver='cg'")
            if not dia:
                raise ValueError(
                    "fused_local_cg requires the DIA operator "
                    "(spmv_format='dia' or a banded matrix under 'auto')")
            raise ValueError(
                "fused_local_cg requirements not met: needs f32 local "
                "compute (dtype='float32' or local_compute_dtype="
                "'float32'), a pure-DIA operator with zero ELL remainder "
                f"(got remainder={self.dia_has_remainder}), rows % 128 "
                f"== 0 (set row_pad_multiple=128; got {R}), and "
                "precond in (none, jacobi, fsai)")
        self.use_fused_cg = gate and (s.fused_local_cg
                                      or device.type == "cuda")
        # the unfused CG and GMRES test their residuals on the host
        self.reads_host = (s.local_solver in ITERATIVE
                           and not self.use_fused_cg)
        # the inner budget (solve.cpp:729-742)
        self._cap = s.local_max_iters if s.local_max_iters > 0 else R
        self._reset = (s.reset_local_crit_iter
                       if s.reset_local_crit_iter >= 0
                       and s.local_max_iters > 0 else None)
        self._inverse = None
        if s.local_solver in ITERATIVE:
            self._solve = self._krylov()
        else:
            # the factors of the (O-RAS solve) operator, in the inner dtype
            fac = lv_solve.astype(dtype).astype(lc_np or dtype)
            self._solve = self._direct(
                torch.from_numpy(rows(fac)).to(device),
                torch.from_numpy(rows(
                    dec.lmat_cols.astype(np.int64))).to(device),
                rows(dec.iface_rows))

    def _put(self, **entries: np.ndarray) -> Dict[str, torch.Tensor]:
        """Host ``entries`` cut to this process's rows, into ``plan``."""
        out = plan_from_numpy({k: self._rows(v) for k, v in entries.items()},
                              self.device)
        self.plan.update(out)
        return out

    def operator(self, inner: bool) -> Callable:
        """y = A_local @ x for the whole batch: DIA (K1) + remainder when
        extracted, ELL otherwise; ``inner`` the local solve's copy, which
        ``inner_operator='dia_only'`` keeps without the remainder."""
        vals, rem = self._inner if inner else self._outer
        if self.dia_offsets is None:
            cols = self.plan["lmat_cols"]
            return lambda x: ell_spmv_batched(vals, cols, x)
        offsets, rr, rc = (self.dia_offsets, self.plan["rem_rows"],
                           self.plan["rem_cols"])
        has_rem = self.dia_has_remainder and not (
            inner and self.settings.inner_operator == "dia_only")
        return lambda x: dia_ell_spmv(offsets, vals, rr, rem, rc, x,
                                      has_remainder=has_rem)

    def _krylov(self) -> Callable:
        """``(rhs, z0, max_it, out_dtype) -> (z, iters, rel)``: K3, or the
        batched CG or GMRES with the preconditioner over the inner
        operator."""
        s, p = self.settings, self.plan
        tol = s.local_tolerance
        if self.use_fused_cg:
            dinv = p["precond_dinv"] if s.precond == Precond.jacobi else None
            fsai = None
            if self.fsai_offsets is not None:
                go, uo = self.fsai_offsets
                fsai = (go, p["fsai_gl_dia"], uo, p["fsai_gu_dia"])
            offsets, dv = self.dia_offsets, self._inner[0]

            def run(rhs, z0, max_it):
                return fused_cg_solve(offsets, dv, rhs.contiguous(),
                                      z0.contiguous(), dinv, tol, max_it,
                                      fsai=fsai)
        else:
            krylov = (cg_solve if s.local_solver == LocalSolver.iterative_cg
                      else functools.partial(gmres_solve,
                                             restart=s.restart_iter))
            kw = dict(precond=self.precond, apply_fn=self.operator(inner=True))

            def run(rhs, z0, max_it):
                return krylov(None, None, rhs, z0, tol, max_it, **kw)

        def solve(rhs, z0, max_it, out_dtype):
            res = run(rhs, z0, max_it)
            return (res.x.to(out_dtype), res.iters,
                    res.rel_resnorm.to(out_dtype))

        return solve

    def _direct(self, vals: torch.Tensor, cols: torch.Tensor,
                iface_rows: np.ndarray) -> Callable:
        """Dense factors of every local matrix (solve.cpp:237-238) into
        ``plan``, and their solve ``(rhs, z0, max_it, out_dtype) -> (z,
        ones, zeros)``.  With ``direct_apply='inverse'`` only the explicit
        inverse stays (and under ``comm.overlap_split`` its interface
        columns).  Each step is the span ``factor`` or ``inverse``, the
        device synchronized inside it."""
        s, p = self.settings, self.plan

        def step(name, fn):
            with span(name):
                out = fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            return out

        if s.local_solver == LocalSolver.direct_lu:
            lu = p["factor_lu"], p["factor_piv"] = step(
                "factor", lambda: direct.lu_factor(vals, cols))
            apply = functools.partial(direct.lu_solve, lu)
        elif s.direct_apply == "inverse":
            L = step("factor", lambda: direct.cholesky_factor(vals, cols))
            inv = self._inverse = p["factor_inv"] = step(
                "inverse", lambda: direct.cholesky_inverse(L))
            del L
            apply = functools.partial(direct.inverse_apply, inv)
            if s.comm.overlap_split:
                # the inverse's columns at the interface rows; padding
                # entries (row index R) give zero columns
                rows = torch.from_numpy(iface_rows.astype(np.int64)).to(
                    self.device)[:, None, :]
                R = inv.shape[-1]
                ic = torch.gather(inv, 2, rows.clamp(max=R - 1).expand(
                    inv.shape[0], R, rows.shape[-1]))
                p["factor_inv_iface"] = torch.where(rows < R, ic,
                                                    torch.zeros_like(ic))
        else:
            L = p["factor_L"] = step(
                "factor", lambda: direct.cholesky_factor(vals, cols))
            apply = functools.partial(direct.cholesky_solve, L)
            if s.direct_apply == "blocked":
                blk = direct.pick_trisolve_block(int(L.shape[-1]))
                p["factor_Dinv"] = step(
                    "inverse", lambda: direct.block_diag_inverses(L, blk))
                apply = functools.partial(direct.blocked_cholesky_solve, L,
                                          p["factor_Dinv"])

        def solve(rhs, z0, max_it, out_dtype):
            z = apply(rhs)
            S = rhs.shape[0]
            return (z.to(out_dtype),
                    torch.ones(S, dtype=torch.int32, device=z.device),
                    torch.zeros(S, dtype=out_dtype, device=z.device))

        return solve

    def z_base(self, rhs: torch.Tensor) -> torch.Tensor:
        """``comm.overlap_split``'s hoisted ``z_base = A_loc^-1 b_loc``: the
        explicit inverse's product, or the local solve uncapped."""
        inv = self._inverse
        if inv is not None:
            return direct.inverse_apply(inv, rhs.to(inv.dtype))
        zb, _, _ = self(rhs, torch.zeros_like(rhs), budget=self.max_rows)
        return zb

    @spanned("local_solve")
    def __call__(self, rhs: torch.Tensor, z_prev: torch.Tensor,
                 outer_it: Optional[int] = None,
                 robin_trace: Optional[torch.Tensor] = None,
                 budget: Optional[int] = None):
        """``(z, iters, rel)`` from ``z_prev``, in the dtype of ``rhs``.
        The inner budget is ``local_max_iters`` (the subdomain size when
        unset; under ``reset_local_crit_iter`` until that outer iteration),
        or ``budget``.  Under O-RAS the solution form's ``robin_trace`` (the
        exchanged iterate on the local rows) adds its Robin term to the
        rhs."""
        if budget is None:
            budget = self._cap
            if self._reset is not None and outer_it is not None:
                budget = (self.settings.local_max_iters
                          if outer_it > self._reset else self.max_rows)
        out_dtype = rhs.dtype
        if self._robin is not None and robin_trace is not None:
            rhs = rhs + self._robin * robin_trace
        if self.lc_dtype is not None:
            # mixed-precision inner solve (iterative refinement)
            rhs = rhs.to(self.lc_dtype)
            z_prev = z_prev.to(self.lc_dtype)
        return self._solve(rhs, z_prev, budget, out_dtype)
