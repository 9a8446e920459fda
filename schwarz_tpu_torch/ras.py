"""Restricted additive Schwarz solver: the port of ``schwarz_tpu/ras.py``,
synchronous, one or two levels, plus the free-running dispatch
(:func:`make_free_running_solver`, ``Settings(free_running=True)``).

The reference's per-rank loop {exchange_boundary -> update_boundary ->
check_convergence -> local_solve -> local_to_global_vector}
(schwarz_base.cpp:322-506) runs as a Python loop over a state dictionary,
with all S subdomains batched on one device:

  - exchange_boundary  -> x_ext in one launch of K2            (parallel/exchange.py),
                          after packed neighbour rounds, one-sided through
                          K4                        (parallel/neighbor_exchange.py)
  - update_boundary    -> interface gather/scatter             (restricted_schwarz.cpp:991-1017)
  - check_convergence  -> local residual through the DIA SpMV (K1) + protocol round
  - coarse correction  -> restriction, coarse solve, prolongation, then a
                          second exchange                    (coarse_correction.py)
  - local_solve        -> batched CG or GMRES with a local preconditioner
                          (Jacobi, block-Jacobi, ILU(0), FSAI(0); their
                          banded factors through K1), the fused CG kernel
                          (K3), or a dense Cholesky / LU factor applied by
                          triangular solves or an explicit inverse
                          (solvers/direct.py)
  - local_to_global    -> interior-window write                (communicate.cpp:64-94)

Optimized Schwarz (``oras_weight``) adds a Robin term to the local solve
operator's boundary rows and the matching trace term to its rhs.
``comm.overlap_split`` hoists the loop-invariant half of the local solve,
``z_base = A_loc^-1 b_loc``, out of the iteration.  ``run_accelerated``
(and ``solve`` with ``accelerator='fgmres'``) solves the global system by
flexible GMRES with one RAS application as its preconditioner.  ``run``
saves and resumes checkpoints in the JAX package's ``.npz`` format, and
``set_rhs`` puts a new right-hand side on a built solver.
``run_instrumented`` is ``run`` with each stage timed on the host clock,
the device synchronized (the reference's five timed regions).

:class:`RASolver` and :func:`solve` run on the CUDA device unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.  With no GPU and no explicit device they raise.  ``num_ranks``
takes the place of the JAX package's device mesh: the neighbour strategies
pack one buffer per pair of ranks, each rank owning ``S / num_ranks``
consecutive subdomains (one by default).  ``free_running`` belongs to the
free-running solvers, which :func:`solve` dispatches to; the synchronous
solver raises ``NotImplementedFeature`` on it.

``mesh`` (:class:`~schwarz_tpu_torch.parallel.mesh.Mesh`) spreads the ranks
over the processes of a ``torch.distributed`` group, the JAX package's
multi-controller mesh.  Every process builds the host setup whole (the
partition, the decomposition, the coarse bases) from the same inputs and
keeps its block of S / P subdomains of every plan array; the exchange, the
convergence round, the coarse solve and FGMRES's inner products then cross
the processes through the mesh's collectives, and every process returns
the same :class:`RASResult`.  A mesh of one process is the single-process
path.  Across processes the one-sided ``rdma`` strategy launches K4 in each
process for its ranks, which put into peer processes' windows through the
mesh's CUDA IPC window (on CPU tensors its plain version moves the rounds
through ``Mesh.shift``); ``free_running`` deals the free-running tiers'
ranks to the processes the same way (:func:`make_free_running_solver`);
and the checkpoints gather the state's blocks, process 0 writes the JAX
package's file, and each process reads back its block.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from schwarz_tpu_torch.config import (
    HaloStrategy,
    LocalCriterion,
    LocalSolver,
    Partition,
    Precond,
    Settings,
)
from schwarz_tpu_torch.coarse_correction import coarse_arrays, coarse_correct
from schwarz_tpu_torch.core.decompose import Decomposition
from schwarz_tpu_torch.core.partition import make_partition
from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops import async_ras_2d
from schwarz_tpu_torch.ops.async_ras import (
    F32_TOL_FLOOR,
    AsyncRASolver,
    plan_geometry,
)
from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
from schwarz_tpu_torch.ops.dia import dia_ell_spmv, dia_spmv, split_dia_ell
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv_chain
from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve, fused_cg_supported
from schwarz_tpu_torch.ops.rdma_kernel import rdma_fault, rdma_shift_finish
from schwarz_tpu_torch.ops.spmv import ell_spmv_batched
from schwarz_tpu_torch.parallel.convergence import (ConvState, conv_step,
                                                    init_conv_state)
from schwarz_tpu_torch.parallel.exchange import (
    exchange_halo_allgather,
    segments_of,
)
from schwarz_tpu_torch.parallel.mesh import Mesh, cut, write_once
from schwarz_tpu_torch.parallel.neighbor_exchange import (
    build_neighbor_plan,
    exchange_halo_neighbor,
    exchange_rounds,
)
from schwarz_tpu_torch.solvers.cg import cg_solve
from schwarz_tpu_torch.solvers.direct import (block_diag_inverses,
                                              blocked_cholesky_solve,
                                              cholesky_factor,
                                              cholesky_inverse,
                                              cholesky_solve, inverse_apply,
                                              lu_factor, lu_solve,
                                              pick_trisolve_block)
from schwarz_tpu_torch.solvers.global_krylov import fgmres
from schwarz_tpu_torch.solvers.gmres import gmres_solve
from schwarz_tpu_torch.solvers.precond import (block_jacobi_inverse,
                                              build_fsai, build_ilu0,
                                              ell_to_dia, ilu_apply_ell,
                                              jacobi_inverse)
from schwarz_tpu_torch.utils.timing import StageTimer

DIVERGENCE_LIMIT = 1e12  # schwarz_base.cpp:424: abort when ||r|| exceeds this
ITERATIVE = (LocalSolver.iterative_cg, LocalSolver.iterative_gmres)
# the state's entries in the order of the JAX package's checkpoint files
# (``jax.tree.flatten`` of its state dict: keys sorted, ConvState's fields
# in their order)
STATE_KEYS = ("conv", "diverged", "grn", "hist_global", "hist_inner",
              "hist_inner_rel", "hist_local", "it", "it_stop", "local_rn0",
              "nconv", "x_ext", "x_own", "z")
# the axis of each state leaf that carries the subdomains, which processes
# hold in blocks; the other leaves (scalars, hist_global, the protocol
# state) are whole in every process
SUBD_AXIS = {"x_own": 0, "x_ext": 0, "z": 0, "local_rn0": 0,
             "hist_local": 1, "hist_inner": 1, "hist_inner_rel": 1}
_HOST_SCALARS = {"diverged": np.bool_, "it": np.int32, "it_stop": np.int32,
                 "nconv": np.int32}


def resolve_device(device=None) -> torch.device:
    """The device a solver runs on: CUDA unless the caller names another.
    There is no silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "schwarz_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def oras_weight(settings: Settings) -> float:
    """The O-RAS coefficient of ``settings.oras_weight``: ``"auto"`` is the
    JAX package's coarse-space-aware default, -0.6 under ``two_level`` and
    -0.8 otherwise."""
    if settings.oras_weight == "auto":
        return -0.6 if settings.two_level else -0.8
    try:
        return float(settings.oras_weight)
    except (TypeError, ValueError):
        raise ValueError(
            f"oras_weight must be a float or 'auto', got "
            f"{settings.oras_weight!r}") from None


def plan_from_numpy(arrays: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """Host plan arrays (decomposition fields, DIA split, run tables) as
    tensors on ``device``, with their dtypes kept."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _interface_contrib(plan, x_ext: torch.Tensor) -> torch.Tensor:
    """(S, Oi) per-interface-row values of ``A_interface @ x_ext`` (the
    row-compacted product before scattering)."""
    cols = plan["iface_cols"]                     # (S, Oi, Wi) int64
    gathered = torch.gather(x_ext, 1, cols.reshape(cols.shape[0], -1))
    return torch.sum(plan["iface_vals"] * gathered.reshape(cols.shape),
                     dim=-1)


def _interface_scatter(plan, contrib: torch.Tensor,
                       base: torch.Tensor) -> torch.Tensor:
    """``base + scatter(contrib)`` onto the interface rows (unique per
    subdomain; padding entries target the extra column R, sliced away)."""
    R = base.shape[1]
    return F.pad(base, (0, 1)).scatter_add(
        1, plan["iface_rows"], contrib)[:, :R].contiguous()


@dataclasses.dataclass
class RASResult:
    """Solve outcome (the reference prints these at schwarz_base.cpp:473-499)."""

    solution: np.ndarray            # (N,) in the ORIGINAL row ordering
    converged: bool
    diverged: bool
    iters: int                      # outer iterations to convergence
    residual_norm: float            # true ||b - A x||_2 (solve.cpp:1024-1085)
    relative_residual_norm: float   # / ||b||_2
    local_resnorm_history: np.ndarray   # (iters run, S)
    global_resnorm_history: np.ndarray  # (iters run,)
    inner_iters_history: np.ndarray     # (iters run, S)
    solve_time_s: float
    comm_matrix: np.ndarray         # (S, S) per-neighbor element volumes/iter
    # per-stage wall-time summary; populated by run_instrumented() and
    # run_accelerated(instrument=True) only (C29)
    stage_timings: Optional[dict] = None


class RASolver:
    """Set up once, run many times (cf. SolverRAS construct/initialize/run)."""

    def __init__(self, dec: Decomposition, device=None,
                 num_ranks: Optional[int] = None, mesh: Optional[Mesh] = None):
        if mesh is not None:
            if num_ranks is not None and int(num_ranks) != mesh.num_ranks:
                raise ValueError(
                    f"num_ranks {num_ranks} differs from the mesh's "
                    f"{mesh.num_ranks} ranks")
            num_ranks = mesh.num_ranks
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        self.dec = dec
        self.settings = dec.settings
        self.meta = dec.meta
        S = self.meta.num_subdomains
        D = S if num_ranks is None else int(num_ranks)
        if D < 1 or S % D != 0:
            raise ValueError(
                f"num_subdomains {S} must be divisible by mesh size {D}")
        self.num_ranks = D
        self.Sl = S // D
        self.mesh = mesh
        # the collectives across processes; None in one process, whose path
        # is the single-process one
        self._mesh = (mesh if mesh is not None and mesh.num_processes > 1
                      else None)
        # this process's subdomains
        self._sub = slice(None) if self._mesh is None else self._mesh.block(S)
        self.S_local = S if self._mesh is None else S // mesh.num_processes
        self._check_supported()
        s = self.settings
        # status words of K4 launches not yet checked (read at the outer
        # iteration's one host sync); across processes, how many of them
        # went through the iteration's gather, and their largest error word
        # over every process
        self._pending_shifts: list = []
        self._folded: Optional[int] = None
        self._folded_err: Optional[torch.Tensor] = None
        self._lc_dtype = None
        if (s.local_compute_dtype is not None
                and s.local_compute_dtype != s.dtype):
            self._lc_dtype = getattr(torch, s.local_compute_dtype)
        # the correction form x += A_loc^-1 r; mixed-precision inner solves
        # require it (a solution-form replace would quantize the iterate to
        # the inner dtype)
        self._residual_update = (
            s.convergence.criterion == LocalCriterion.residual_based
            or self._lc_dtype is not None)
        self._check_local_solver()
        # seconds of the direct factorization on the device, by step
        self.factor_seconds: Dict[str, float] = {}
        self._plan = self._build_plan()
        # the neighbour strategies' round tables, kept with K4's state
        self._rounds = (exchange_rounds(self._neighbor_plan, self.device,
                                        self._mesh)
                        if self._neighbor_plan is not None else None)
        if self._overlap_split:
            self._plan["z_base"] = self._split_z_base()
        self._stages = self._build_stage_fns()

    def _check_supported(self) -> None:
        """Fail loudly on the JAX package's own invalid combinations, on
        the reference's settings that have no function here, and on
        ``free_running``."""
        s = self.settings
        if s.two_level and (
            s.comm.overlap_comm or (s.comm.onesided and s.comm.staleness > 1)
        ):
            raise ValueError(
                "two_level requires fresh halos each iteration; it cannot be "
                "combined with enable_overlap / staleness > 1 (the coarse "
                "correction computed from a stale residual diverges)"
            )
        if s.comm.overlap_comm and s.comm.onesided and s.comm.staleness > 1:
            raise ValueError(
                "enable_overlap is the one-iteration-stale halo pipeline; "
                "with onesided staleness > 1 the staleness emulation owns "
                "the halo age and the overlap flag would be silently inert "
                "— drop enable_overlap (staleness >= 1 already subsumes it)"
            )
        if s.shifted_iter:
            raise NotImplementedFeature(
                "shifted_iter (settings.hpp:212) is read nowhere in the "
                "reference source; unset it")
        if s.comm.stage_through_host:
            raise NotImplementedFeature(
                "stage_through_host exists for non-device-aware MPI; the "
                "port has no host-staged transport — unset it")
        if s.comm.lock_type != "lock-all":
            raise NotImplementedFeature(
                f"lock_type={s.comm.lock_type!r}: only 'lock-all' exists")
        if s.comm.flush_type not in ("flush-all", "flush-local"):
            raise ValueError(
                f"flush_type must be 'flush-all' or 'flush-local', got "
                f"{s.comm.flush_type!r}")
        if s.comm.enable_put == s.comm.enable_get:
            raise ValueError(
                "exactly one of comm.enable_put / comm.enable_get must be set")
        if s.inner_operator not in ("exact", "dia_only"):
            raise ValueError(
                f"inner_operator must be 'exact' or 'dia_only', got "
                f"{s.inner_operator!r}")
        if (s.inner_operator == "dia_only"
                and s.convergence.criterion == LocalCriterion.solution_based):
            # the perturbed inner operator shifts the solution-based fixed
            # point and the exact global check stalls; the correction form
            # keeps the fixed point
            raise ValueError(
                "inner_operator='dia_only' requires the residual-based local "
                "criterion (local_convergence_crit='residual-based'): "
                "solution-based updates take the perturbed operator's fixed "
                "point and the exact convergence check never detects")
        self._oras_c = oras_weight(s)
        if not -1.0 <= self._oras_c <= 0.0:
            raise ValueError(
                f"oras_weight={self._oras_c} outside [-1, 0]: the Robin "
                "ghost elimination gives coefficients in (-1, 0]; values "
                "beyond -1 make the local solve operator indefinite and the "
                "iteration diverges, and positive weights stiffen it in "
                "the wrong direction")
        if s.free_running:
            raise NotImplementedFeature(
                "free_running is the free-running solvers' mode: solve() "
                "dispatches it to them (make_free_running_solver); the "
                "synchronous RASolver does not run it")

    def _check_local_solver(self) -> None:
        """The JAX package's gates on the direct applies and on
        ``comm.overlap_split`` (``schwarz_tpu/ras.py:873-952``).  The
        float64 LU refusal there is a TPU limit and has no counterpart."""
        s = self.settings
        if s.direct_apply not in ("trisolve", "inverse", "blocked"):
            raise ValueError(
                f"direct_apply must be 'trisolve', 'inverse' or 'blocked', "
                f"got {s.direct_apply!r}")
        if (s.direct_apply in ("inverse", "blocked")
                and s.local_solver == LocalSolver.direct_lu):
            raise ValueError(
                f"direct_apply={s.direct_apply!r} requires "
                "local_solver='cholesky' (both paths build on the SPD "
                "Cholesky factor)")
        # exact comm/compute overlap (the reference's enable_overlap without
        # changing the iterate, restricted_schwarz.cpp:886-943): the
        # loop-invariant half z_base = A_loc^-1 b_loc is hoisted out of the
        # iteration; the explicit inverse keeps only the (R x Oi) boundary
        # correction, iterative locals take the correction form
        self._overlap_split = bool(s.comm.overlap_split)
        self._split_iterative = (self._overlap_split
                                 and s.local_solver in ITERATIVE)
        if not self._overlap_split:
            return
        missing = []
        if not (self._split_iterative
                or (s.local_solver == LocalSolver.direct_cholesky
                    and s.direct_apply == "inverse")):
            missing.append(
                "local_solver='cholesky' with direct_apply='inverse', or an "
                "iterative local solver (cg/gmres take the correction-form "
                "split; the split is a linearity identity of the solve)")
        if self._oras_c != 0:
            missing.append("no O-RAS (Robin rhs data is dense)")
        if (s.convergence.criterion == LocalCriterion.residual_based
                or self._lc_dtype is not None):
            missing.append(
                "solution-based updates (residual_based / "
                "local_compute_dtype solve the dense correction system; a "
                "low-precision hoisted z_base would also cap the achievable "
                "outer residual at inner-dtype accuracy)")
        if missing:
            raise ValueError(
                "comm.overlap_split requires: " + "; ".join(missing))

    # ------------------------------------------------------------------ setup --
    def _build_plan(self) -> Dict[str, torch.Tensor]:
        dec = self.dec
        s = self.settings
        meta = self.meta
        dtype = np.dtype(s.dtype)
        S, R_int, R_rows = (meta.num_subdomains, meta.max_interior,
                            meta.max_rows)
        _, interior_valid, _ = dec.masks()
        off = dec.interior_offset.astype(np.int64)
        arrays = {
            "iface_rows": dec.iface_rows.astype(np.int64),
            "iface_vals": dec.iface_vals.astype(dtype),
            "iface_cols": dec.iface_cols.astype(np.int64),
            "local_rhs": dec.local_rhs.astype(dtype),
            "interior_mask": interior_valid,
            # column of each interior slot in the closure (0 off the mask)
            "int_cols": np.where(interior_valid,
                                 off[:, None] + np.arange(R_int), 0),
            "adj_in": dec.comm_matrix > 0,
        }
        lc_np = None if self._lc_dtype is None else np.dtype(
            s.local_compute_dtype)
        # DIA + remainder local operator; "auto" picks it on the card, as the
        # JAX package picks it on a TPU (the CPU keeps the ELL gathers)
        self._dia_offsets = None
        self._dia_has_remainder = True
        on_cuda = self.device.type == "cuda"
        if s.spmv_format == "dia" or (s.spmv_format == "auto" and on_cuda):
            hyb = split_dia_ell(dec.lmat_vals, dec.lmat_cols, dec.rows_count,
                                max_diags=s.dia_max_diags)
            dia_nnz = int((hyb.dia_vals != 0).sum())
            total_nnz = max(int((dec.lmat_vals != 0).sum()), 1)
            if s.spmv_format == "dia" or dia_nnz >= 0.5 * total_nnz:
                self._dia_offsets = hyb.offsets
                self._dia_has_remainder = bool(np.count_nonzero(hyb.rem_vals))
                arrays["dia_vals"] = hyb.dia_vals.astype(dtype)
                arrays["rem_rows"] = hyb.rem_rows.astype(np.int64)
                arrays["rem_vals"] = hyb.rem_vals.astype(dtype)
                arrays["rem_cols"] = hyb.rem_cols.astype(np.int64)
                if lc_np is not None:
                    arrays["dia_vals_lc"] = hyb.dia_vals.astype(lc_np)
                    arrays["rem_vals_lc"] = hyb.rem_vals.astype(lc_np)
        # O-RAS: the local SOLVE operator's boundary rows gain c * sum |dropped
        # couplings| on the diagonal (the first col == row entry only);
        # residuals and the convergence check keep the true A.  The rhs
        # gains the matching c * D * trace in _local_solve, so the fixed
        # point is exactly A x = b (ras.py:624-680 of the JAX package)
        self._oras = self._oras_c != 0
        lv_solve = dec.lmat_vals
        if self._oras:
            srows = np.broadcast_to(np.arange(S)[:, None], dec.iface_rows.shape)
            boost_pad = np.zeros((S, R_rows + 1), dtype=np.float64)
            np.add.at(boost_pad, (srows, dec.iface_rows),
                      np.abs(dec.iface_vals).sum(axis=2))
            boost = self._oras_c * boost_pad[:, :R_rows]
            arrays["oras_diag"] = boost.astype(dtype)
            if self._dia_offsets is not None:
                dv = hyb.dia_vals.copy()
                dv[:, self._dia_offsets.index(0), :] += boost
                arrays["dia_vals_solve"] = dv.astype(dtype)
                if lc_np is not None:
                    arrays["dia_vals_solve_lc"] = dv.astype(lc_np)
            rows_idx = np.arange(R_rows)[None, :, None]
            dmask = dec.lmat_cols == rows_idx
            first = dmask & (np.cumsum(dmask, axis=2) == 1)
            lv_solve = dec.lmat_vals + boost[:, :, None] * first
        if self._dia_offsets is None:
            arrays["lmat_vals"] = dec.lmat_vals.astype(dtype)
            arrays["lmat_cols"] = dec.lmat_cols.astype(np.int64)
            if lc_np is not None:
                arrays["lmat_vals_lc"] = dec.lmat_vals.astype(lc_np)
            if self._oras:
                arrays["lmat_vals_solve"] = lv_solve.astype(dtype)
                if lc_np is not None:
                    arrays["lmat_vals_solve_lc"] = lv_solve.astype(lc_np)
        if s.local_solver in ITERATIVE:
            arrays.update(self._precond_arrays(lv_solve.astype(dtype),
                                               lc_np or dtype))
        if s.two_level:
            arrays.update(coarse_arrays(dec, s, dtype, lc_np))
        # fused whole-solve CG kernel: opt-in and gated; an unsatisfiable
        # request fails loudly with the recipe
        self._use_fused_cg = False
        if s.fused_local_cg:
            if s.local_solver != LocalSolver.iterative_cg:
                raise ValueError("fused_local_cg requires local_solver='cg'")
            if self._dia_offsets is None:
                raise ValueError(
                    "fused_local_cg requires the DIA operator "
                    "(spmv_format='dia' or a banded matrix under 'auto')")
            inner_dtype = self._lc_dtype or s.value_dtype
            if not fused_cg_supported(
                S, R_rows, len(self._dia_offsets), inner_dtype,
                self._dia_has_remainder, s.precond.value,
            ):
                raise ValueError(
                    "fused_local_cg requirements not met: needs f32 local "
                    "compute (dtype='float32' or local_compute_dtype="
                    "'float32'), a pure-DIA operator with zero ELL remainder "
                    f"(got remainder={self._dia_has_remainder}), rows % 128 "
                    f"== 0 (set row_pad_multiple=128; got {R_rows}), and "
                    "precond in (none, jacobi)")
            self._use_fused_cg = True
        # K2's segments of x_ext: the halo as runs of the gathered
        # interiors, or as the neighbour strategies' compact halo values,
        # whose packed per-rank-pair tables come with them; rounds within a
        # process run before rounds that cross processes
        self._neighbor_plan = None
        compact = s.comm.strategy in (HaloStrategy.neighbor,
                                      HaloStrategy.rdma)
        if compact:
            process_of = (self.mesh.process_of if self.mesh is not None
                          else [0] * self.num_ranks)
            self._neighbor_plan = build_neighbor_plan(
                dec, self.num_ranks, process_of=process_of)
        if self._mesh is not None:
            # this process's block of every per-subdomain array: rows
            # [lo k, hi k) of one whose leading axis is S k (the coarse
            # inverse, (S q, S q), keeps its row block); the halo graph
            # stays whole for the convergence protocols, and A_c for the
            # coarse CG (coarse_correction.py)
            arrays = {k: (v if k in ("adj_in", "coarse_mat")
                          else self._local_rows(v))
                      for k, v in arrays.items()}
        arrays["ext_segs"], arrays["ext_first"] = segments_of(
            dec, compact, self._sub)
        plan = plan_from_numpy(arrays, self.device)
        if s.local_solver not in ITERATIVE:
            # the factors of the (O-RAS solve) operator, in the inner dtype
            fac = lv_solve.astype(dtype).astype(lc_np or dtype)
            plan.update(self._direct_factors(
                torch.from_numpy(self._local_rows(fac)).to(self.device),
                torch.from_numpy(self._local_rows(
                    dec.lmat_cols.astype(np.int64))).to(self.device)))
        if self._overlap_split and not self._split_iterative:
            # the inverse's columns at the interface rows; padding entries
            # (row index R) give zero columns
            inv = plan["factor_inv"]
            rows = plan["iface_rows"][:, None, :]
            R = inv.shape[-1]
            cols = torch.gather(inv, 2, rows.clamp(max=R - 1).expand(
                inv.shape[0], R, rows.shape[-1]))
            plan["factor_inv_iface"] = torch.where(rows < R, cols,
                                                   torch.zeros_like(cols))
        return plan

    def _local_rows(self, a: np.ndarray) -> np.ndarray:
        """This process's rows of a plan array whose leading axis is S k."""
        if self._mesh is None:
            return a
        S = self.meta.num_subdomains
        k, rem = divmod(a.shape[0], S)
        if rem or not k:
            raise ValueError(f"plan array of {a.shape[0]} rows is not dealt "
                             f"by {S} subdomains")
        return a[self._sub.start * k:self._sub.stop * k]

    def _global(self, t: torch.Tensor, axis: int = 0) -> np.ndarray:
        """The whole of a per-subdomain array on the host: the processes'
        blocks along ``axis`` gathered, or the tensor itself in one
        process."""
        if self._mesh is None:
            return t.cpu().numpy()
        if axis == 0:
            return self._mesh.process_allgather(t.contiguous())
        return self._mesh.process_allgather(
            t.movedim(axis, 0).contiguous()).swapaxes(0, axis)

    def _direct_factors(self, vals: torch.Tensor,
                        cols: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Dense factors of every local matrix, once at setup
        (solve.cpp:237-238), on the device.  With ``direct_apply=
        'inverse'`` only the explicit inverse stays: the densified operator
        and the factor are freed as soon as it exists.  The seconds of each
        step go to ``factor_seconds``."""
        s = self.settings

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            self._synchronize()
            self.factor_seconds[name] = time.perf_counter() - t0
            return out

        if s.local_solver == LocalSolver.direct_lu:
            lu, piv = timed("factor", lambda: lu_factor(vals, cols))
            return {"factor_lu": lu, "factor_piv": piv}
        L = timed("factor", lambda: cholesky_factor(vals, cols))
        if s.direct_apply == "inverse":
            return {"factor_inv": timed("inverse",
                                        lambda: cholesky_inverse(L))}
        if s.direct_apply == "blocked":
            blk = pick_trisolve_block(int(L.shape[-1]))
            return {"factor_L": L, "factor_Dinv": timed(
                "inverse", lambda: block_diag_inverses(L, blk))}
        return {"factor_L": L}

    def _split_z_base(self) -> torch.Tensor:
        """The hoisted half of ``overlap_split``, ``z_base = A_loc^-1
        b_loc``: one product with the explicit inverse, or for iterative
        locals the production local solve with an uncapped budget (the
        per-iteration solves keep ``local_max_iters``)."""
        rhs = self._plan["local_rhs"]
        if not self._split_iterative:
            inv = self._plan["factor_inv"]
            return inverse_apply(inv, rhs.to(inv.dtype))
        zb, _, _ = self._local_solve(rhs, torch.zeros_like(rhs),
                                     budget=self.meta.max_rows)
        return zb

    def _precond_arrays(self, pv: np.ndarray, pdtype) -> Dict[str, np.ndarray]:
        """The local preconditioner's plan entries, built on the host from
        ``pv``, the (O-RAS solve) operator in the outer dtype, and stored
        in the inner dtype ``pdtype`` (``ras.py:965-1060`` of the JAX
        package).  ILU(0) and FSAI(0) factors go to DIA form on the DIA
        operator, so their products are K1 on the card."""
        s = self.settings
        cols = self.dec.lmat_cols
        dia = self._dia_offsets is not None
        out = {}
        if s.precond == Precond.jacobi:
            out["precond_dinv"] = jacobi_inverse(pv, cols).astype(pdtype)
        elif s.precond == Precond.ilu:
            lv, lc, uv, uc, ud = build_ilu0(pv, cols)
            out["ilu_udinv"] = (1.0 / ud).astype(pdtype)
            if dia:
                lo, ld = ell_to_dia(lv, lc)
                uo, udia = ell_to_dia(uv, uc)
                self._ilu_offsets = (lo, uo)
                out["ilu_l_dia"] = ld.astype(pdtype)
                out["ilu_u_dia"] = udia.astype(pdtype)
            else:
                out.update(ilu_l_vals=lv.astype(pdtype), ilu_l_cols=lc,
                           ilu_u_vals=uv.astype(pdtype), ilu_u_cols=uc)
        elif s.precond == Precond.fsai:
            if dia:
                # the pattern restricted to the DIA offsets keeps both
                # factors banded when the operator has an ELL remainder;
                # M stays SPD, only a weaker approximation
                rows = np.arange(pv.shape[1])[None, :, None]
                on_dia = np.isin(cols.astype(np.int64) - rows,
                                 np.asarray(self._dia_offsets))
                pv = np.where(on_dia, pv, 0.0)
            glv, glc, guv, guc = build_fsai(pv, cols)
            if dia:
                go, gd = ell_to_dia(glv, glc)
                uo, ud = ell_to_dia(guv, guc)
                self._fsai_offsets = (go, uo)
                out["fsai_gl_dia"] = gd.astype(pdtype)
                out["fsai_gu_dia"] = ud.astype(pdtype)
            else:
                out.update(fsai_gl_vals=glv.astype(pdtype), fsai_gl_cols=glc,
                           fsai_gu_vals=guv.astype(pdtype), fsai_gu_cols=guc)
        elif s.precond == Precond.block_jacobi:
            out["precond_blockinv"] = block_jacobi_inverse(
                pv, cols, s.block_jacobi_block_size).astype(pdtype)
        return out

    # ------------------------------------------------------------- the stages --
    def _exchange(self, x_own: torch.Tensor) -> torch.Tensor:
        """Halo exchange (strategy dispatch): x_ext from the interiors."""
        plan = self._plan
        s = self.settings
        halo_dtype = (s.halo_value_dtype
                      if s.halo_value_dtype != s.value_dtype else None)
        segments = (plan["ext_segs"], plan["ext_first"])
        if self._rounds is not None:
            return exchange_halo_neighbor(
                x_own.contiguous(), segments, self._rounds,
                self.meta.max_ext, halo_dtype=halo_dtype,
                transport=("rdma" if s.comm.strategy == HaloStrategy.rdma
                           else "ppermute"),
                rdma_mode="put" if s.comm.enable_put else "get",
                rdma_one_by_one=s.comm.enable_one_by_one,
                rdma_flush_local=s.comm.flush_type == "flush-local",
                pending=self._pending_shifts,
                shift=None if self._mesh is None else self._mesh.shift,
            )
        return exchange_halo_allgather(x_own.contiguous(), segments,
                                       self.meta.max_ext,
                                       halo_dtype=halo_dtype,
                                       mesh=self._mesh)

    def _apply_local(self, inner: bool = False):
        """y = A_local @ x for the whole batch: DIA (K1) + remainder when
        extracted, ELL otherwise.  ``inner`` selects the local solve's copy
        of the operator: in the local-compute dtype, and with the Robin
        term under O-RAS; the residual and the check keep the true A.
        ``inner_operator='dia_only'`` drops the ELL remainder from the inner
        copy only."""
        plan = self._plan
        lc = "_lc" if (inner and self._lc_dtype is not None) else ""
        solve = "_solve" if (inner and self._oras) else ""
        if self._dia_offsets is not None:
            offsets = self._dia_offsets
            dv, rr, rv, rc = (plan["dia_vals" + solve + lc], plan["rem_rows"],
                              plan["rem_vals" + lc], plan["rem_cols"])
            has_rem = self._dia_has_remainder and not (
                inner and self.settings.inner_operator == "dia_only")
            return lambda x: dia_ell_spmv(offsets, dv, rr, rv, rc, x,
                                          has_remainder=has_rem)
        lv, lcols = plan["lmat_vals" + solve + lc], plan["lmat_cols"]
        return lambda x: ell_spmv_batched(lv, lcols, x)

    def _precond_fn(self):
        """The local preconditioner's apply ``z = M^-1 r``, or None
        (``ras.py:1117-1186`` of the JAX package)."""
        plan = self._plan
        if "precond_dinv" in plan:
            dinv = plan["precond_dinv"]
            return lambda r: dinv * r
        if "ilu_udinv" in plan:
            sweeps = self.settings.ilu_sweeps
            udinv = plan["ilu_udinv"]
            if "ilu_l_dia" not in plan:
                return lambda r: ilu_apply_ell(
                    plan["ilu_l_vals"], plan["ilu_l_cols"],
                    plan["ilu_u_vals"], plan["ilu_u_cols"], udinv, r, sweeps)
            lo, uo = self._ilu_offsets
            ld, ud = plan["ilu_l_dia"], plan["ilu_u_dia"]

            def apply_ilu_dia(r):
                y = r
                for _ in range(sweeps):
                    y = r - dia_spmv(lo, ld, y)
                x = udinv * y
                for _ in range(sweeps):
                    x = udinv * (y - dia_spmv(uo, ud, x))
                return x

            return apply_ilu_dia
        if "fsai_gl_dia" in plan:
            # M r = G^T (G r): one chained launch of K1 on the card
            go, uo = self._fsai_offsets
            gd, ud = plan["fsai_gl_dia"], plan["fsai_gu_dia"]
            return lambda r: dia_spmv_chain(go, gd, uo, ud, r)
        if "fsai_gl_vals" in plan:
            return lambda r: ell_spmv_batched(
                plan["fsai_gu_vals"], plan["fsai_gu_cols"],
                ell_spmv_batched(plan["fsai_gl_vals"], plan["fsai_gl_cols"],
                                 r))
        if "precond_blockinv" in plan:
            inv_blocks = plan["precond_blockinv"]
            bs = self.settings.block_jacobi_block_size

            def apply_block_jacobi(r):
                S, R = r.shape
                zb = torch.einsum("sbij,sbj->sbi", inv_blocks,
                                  r.reshape(S, R // bs, bs))
                return zb.reshape(S, R)

            return apply_block_jacobi
        return None

    def _extract_int(self, z: torch.Tensor) -> torch.Tensor:
        """Interior window ``z[off : off + R_int]`` per subdomain, zero on
        the padding (the local->global write of communicate.cpp:64-94)."""
        plan = self._plan
        win = torch.gather(z, 1, plan["int_cols"])
        return torch.where(plan["interior_mask"], win, torch.zeros_like(win))

    def _interface_update(self, x_ext: torch.Tensor):
        """``(rhs_eff, g)``: rhs_eff = local_rhs - A_interface @ x_ext
        (update_boundary, restricted_schwarz.cpp:991-1017) in the gather
        form, and g the (S, Oi) interface contribution."""
        g = _interface_contrib(self._plan, x_ext)
        return (_interface_scatter(self._plan, -g, self._plan["local_rhs"]),
                g)

    def _local_solve(self, rhs_eff, z_prev, outer_it: Optional[int] = None,
                     robin_trace: Optional[torch.Tensor] = None,
                     budget: Optional[int] = None):
        """The batched local solve (solve.cpp:666-792): CG (unfused or K3),
        GMRES, or a direct factor's apply.  ``reset_local_crit_iter``
        (solve.cpp:729-742): outer iterations beyond it switch the inner
        budget from the subdomain size to ``local_max_iters``; ``budget``
        overrides both.  Under O-RAS the solution form passes the
        neighbours' trace (``robin_trace``, the exchanged iterate on the
        local rows), whose Robin term joins the rhs; the correction form
        carries no Robin data (None)."""
        s = self.settings
        R = self.meta.max_rows
        max_it = s.local_max_iters if s.local_max_iters > 0 else R
        if budget is not None:
            max_it = budget
        elif (s.reset_local_crit_iter >= 0 and s.local_max_iters > 0
                and outer_it is not None):
            max_it = (s.local_max_iters if outer_it > s.reset_local_crit_iter
                      else R)
        out_dtype = rhs_eff.dtype
        plan = self._plan
        if self._oras and robin_trace is not None:
            rhs_eff = rhs_eff + plan["oras_diag"] * robin_trace
        if self._lc_dtype is not None:
            # mixed-precision inner solve (iterative refinement)
            rhs_eff = rhs_eff.to(self._lc_dtype)
            z_prev = z_prev.to(self._lc_dtype)
        if self._use_fused_cg:
            lc = "_lc" if self._lc_dtype is not None else ""
            solve = "_solve" if self._oras else ""
            res = fused_cg_solve(
                self._dia_offsets, plan["dia_vals" + solve + lc],
                rhs_eff.contiguous(), z_prev.contiguous(),
                plan.get("precond_dinv"), s.local_tolerance, max_it)
        elif s.local_solver == LocalSolver.iterative_cg:
            res = cg_solve(
                None, None, rhs_eff, z_prev, s.local_tolerance, max_it,
                precond=self._precond_fn(),
                apply_fn=self._apply_local(inner=True))
        elif s.local_solver == LocalSolver.iterative_gmres:
            res = gmres_solve(
                None, None, rhs_eff, z_prev, s.local_tolerance, max_it,
                restart=s.restart_iter, precond=self._precond_fn(),
                apply_fn=self._apply_local(inner=True))
        else:
            if "factor_inv" in plan:
                z = inverse_apply(plan["factor_inv"], rhs_eff)
            elif "factor_Dinv" in plan:
                z = blocked_cholesky_solve(plan["factor_L"],
                                           plan["factor_Dinv"], rhs_eff)
            elif "factor_L" in plan:
                z = cholesky_solve(plan["factor_L"], rhs_eff)
            else:
                z = lu_solve((plan["factor_lu"], plan["factor_piv"]),
                             rhs_eff)
            S = rhs_eff.shape[0]
            return (z.to(out_dtype),
                    torch.ones(S, dtype=torch.int32, device=z.device),
                    torch.zeros(S, dtype=out_dtype, device=z.device))
        return (res.x.to(out_dtype), res.iters,
                res.rel_resnorm.to(out_dtype))

    # -------------------------------------------------------------- solve loop --
    def _build_stage_fns(self) -> Dict[str, Callable]:
        """The stages of one outer iteration as functions of device tensors
        (C29: the five MEASURE_ELAPSED_FUNC_TIME regions,
        schwarz_base.cpp:393-450), plus ``coarse_correction`` and
        ``residual_recompute`` under ``two_level``.  :meth:`_step` calls
        them through ``self._stages``, where :meth:`run_instrumented` puts
        timed copies."""
        s = self.settings
        S = self.meta.num_subdomains
        Sp = self.S_local
        R_rows = self.meta.max_rows
        residual_update = self._residual_update

        def convergence_check(conv, x_ext, rhs_eff, rn0_in):
            # local residual (solve.cpp:795-856) and the protocol round
            r = rhs_eff - self._apply_local()(x_ext[:, :R_rows])
            local_rn = torch.sqrt(torch.sum(r * r, dim=-1))
            rn0 = torch.where(rn0_in < 0, local_rn, rn0_in)
            rn_all, rn0_all = local_rn, rn0
            if self._mesh is not None:
                # every subdomain's norms, one gather an iteration; each
                # process then takes the same transition on the same state.
                # The error words of the K4 launches pending here ride along,
                # so that every process raises together on a fault
                cols = [local_rn, rn0]
                pend = self._pending_shifts
                self._folded = len(pend)
                if pend:
                    err = torch.stack([t[-1] for t in pend]).amax()
                    cols.append(err.to(local_rn.dtype).expand_as(local_rn))
                both = self._mesh.all_gather(torch.stack(cols, 1))
                rn_all, rn0_all = both[:, 0], both[:, 1]
                self._folded_err = both[:, 2].amax() if pend else None
            locally_conv = ((rn_all * rn_all)
                            < (s.tolerance ** 2) * (rn0_all * rn0_all))
            conv, nconv, grn = conv_step(s, S, conv, rn_all, rn0_all,
                                         locally_conv, self._plan["adj_in"])
            return r, local_rn, rn0, conv, nconv, grn

        def coarse_correction(x_own, r, detected):
            # two-level (multiplicative): coarse-correct x from the fresh
            # residual; subdomains that detected keep their iterate
            plan = self._plan
            cfield = coarse_correct(plan, self._extract_int(r), self._mesh)
            return x_own + torch.where(
                detected[:, None] | ~plan["interior_mask"],
                torch.zeros_like(cfield), cfield)

        def residual_recompute(x_ext, rhs_eff):
            return rhs_eff - self._apply_local()(x_ext[:, :R_rows])

        def local_solve(rhs_eff, g, r, z_prev, detected, x_trace, outer_it):
            """``(z, sol_field, inner, inner_rel)``; ``sol_field`` differs
            from the carried ``z`` only under the iterative split."""
            sol_field = None
            if residual_update:
                # solve the correction equation A_local z = r, x += z
                z, inner, inner_rel = self._local_solve(
                    r, torch.zeros_like(z_prev), outer_it=outer_it)
            elif self._overlap_split and not self._split_iterative:
                # exact overlap: z = z_base - A_loc^-1[:, iface] g, the
                # only exchange-dependent work an (R x Oi) product
                zb = self._plan["z_base"]
                z = (zb - inverse_apply(self._plan["factor_inv_iface"],
                                        g.to(zb.dtype))).to(rhs_eff.dtype)
                inner = torch.ones(Sp, dtype=torch.int32, device=self.device)
                inner_rel = torch.zeros(Sp, dtype=rhs_eff.dtype,
                                        device=self.device)
            elif self._overlap_split:
                # correction-form split for iterative locals: only
                # A_loc w = G(x_ext) waits on the exchange (warm-started
                # from the carried w); z = z_base - w
                g_field = _interface_scatter(self._plan, g,
                                             torch.zeros_like(rhs_eff))
                w, inner, inner_rel = self._local_solve(g_field, z_prev,
                                                        outer_it=outer_it)
                sol_field = (self._plan["z_base"] - w).to(rhs_eff.dtype)
                z = w           # the carry warm-starts the next w-solve
            else:
                z, inner, inner_rel = self._local_solve(
                    rhs_eff, z_prev, outer_it=outer_it, robin_trace=x_trace)
            # freeze subdomains that already detected global convergence
            z = torch.where(detected[:, None], z_prev, z)
            return z, sol_field, inner, inner_rel

        def expand_local_vec(z, sol_field, x_own, detected):
            z_int = self._extract_int(z if sol_field is None else sol_field)
            x_new = x_own + z_int if residual_update else z_int
            return torch.where(detected[:, None], x_own, x_new)

        stages = {
            "boundary_exchange": self._exchange,
            "boundary_update": self._interface_update,
            "convergence_check": convergence_check,
            "local_solve": local_solve,
            "expand_local_vec": expand_local_vec,
        }
        if s.two_level:
            stages.update(coarse_correction=coarse_correction,
                          residual_recompute=residual_recompute)
        return stages

    def _drain_shifts(self, folded: Optional[int] = None) -> None:
        """Raise now if a K4 wait timed out; called where the card is idle
        anyway (the outer iteration's one host read).  Across processes
        ``folded`` launches had their error words checked in the iteration's
        gather and only they are read here (a later one waits for the next
        gather); without it (FGMRES's operator) the launches' error words
        are gathered here, so that every process raises together."""
        pending = self._pending_shifts
        if not pending:
            return
        if self._mesh is not None and folded is None:
            err = torch.stack([t[-1] for t in pending]).amax().reshape(1)
            worst = int(self._mesh.all_gather(err).amax())
            if worst:
                rdma_fault(worst)
        n = len(pending) if folded is None else folded
        shifts, pending[:] = pending[:n], pending[n:]
        rdma_shift_finish(shifts)

    def _gate_nconv(self, nconv: int, it: int) -> int:
        """The converged count the loop acts on: none with a non-positive
        tolerance, and none before 5% of ``max_iters`` under
        ``enable_global_check_iter_offset`` (solve.cpp:992-996)."""
        s = self.settings
        if s.tolerance <= 0.0:
            return 0
        if (s.convergence.enable_global_check_iter_offset
                and not (it > s.max_iters * 0.05 or s.max_iters < 1000)):
            return 0
        return nconv

    def _step(self, st: Dict[str, Any]) -> Dict[str, Any]:
        """One outer iteration (the body of the JAX package's run loop)."""
        s = self.settings
        S = self.meta.num_subdomains
        R_rows = self.meta.max_rows
        stage = self._stages
        it = st["it"]
        x_own = st["x_own"]
        # --- exchange_boundary -------------------------------------------
        # stale-halo modes: enable_overlap computes with last iteration's
        # halo and carries the fresh one (restricted_schwarz.cpp:855-973);
        # onesided staleness > 1 refreshes the halo every stale_period
        # iterations, the asynchronous algorithm's aged neighbour data
        stale_period = max(1, s.comm.staleness) if s.comm.onesided else 1
        if s.comm.overlap_comm and stale_period == 1:
            x_ext, x_ext_carry = st["x_ext"], stage["boundary_exchange"](x_own)
        elif stale_period > 1 and it % stale_period != 0:
            x_ext = x_ext_carry = st["x_ext"]
        else:
            x_ext = x_ext_carry = stage["boundary_exchange"](x_own)
        # --- update_boundary: rhs_eff = b_loc - A_interface x_ext --------
        rhs_eff, g = stage["boundary_update"](x_ext)
        # --- local residual + global convergence protocol ----------------
        r, local_rn, rn0, conv_state, nconv, grn = stage["convergence_check"](
            st["conv"], x_ext, rhs_eff, st["local_rn0"])
        diverged = torch.isnan(grn) | (grn > DIVERGENCE_LIMIT)
        st["hist_local"][it] = local_rn
        st["hist_global"][it] = grn
        flags = [nconv, diverged]
        if self._folded_err is not None:
            flags.append(self._folded_err)
        nconv_h, div_h, *err = torch.stack(
            [f.to(torch.float64) for f in flags]).tolist()
        div_h = bool(div_h)
        if err and err[0]:
            rdma_fault(int(err[0]))
        self._drain_shifts(self._folded)
        self._folded, self._folded_err = None, None
        nconv_h = self._gate_nconv(int(nconv_h), it)
        # --- local_solve + local_to_global (skipped on the exit pass) ----
        z_prev = st["z"]
        if nconv_h < S and not div_h:
            detected = conv_state.detected[self._sub]
            x_trace = x_ext[:, :R_rows]     # Robin data under O-RAS
            if s.two_level:
                # coarse-correct, exchange again, and let the local solves
                # act on the corrected boundary data; the pre-coarse
                # residual stays the one reported and checked
                x_own = stage["coarse_correction"](x_own, r, detected)
                x_ext2 = stage["boundary_exchange"](x_own)
                rhs_eff, g = stage["boundary_update"](x_ext2)
                x_trace = x_ext2[:, :R_rows]
                r = stage["residual_recompute"](x_ext2, rhs_eff)
            z, sol_field, inner, inner_rel = stage["local_solve"](
                rhs_eff, g, r, z_prev, detected, x_trace, it)
            x_own = stage["expand_local_vec"](z, sol_field, x_own, detected)
        else:
            # exit pass: leave the iterate exactly as it was detected
            z = z_prev
            inner = torch.zeros(self.S_local, dtype=torch.int32,
                                device=self.device)
            inner_rel = torch.zeros(self.S_local, dtype=s.value_dtype,
                                    device=self.device)
        st["hist_inner"][it] = inner
        st["hist_inner_rel"][it] = inner_rel
        st.update(x_own=x_own, x_ext=x_ext_carry, z=z, local_rn0=rn0,
                  conv=conv_state,
                  nconv=nconv_h, grn=grn, diverged=div_h, it=it + 1)
        return st

    def init_state(self, x0=None) -> Dict[str, Any]:
        """Fresh solver state; device tensors plus host loop counters.
        ``x0`` is the (S, R_int) interior start of every subdomain; across
        processes the state holds the process's subdomains, and the
        protocol state all of them."""
        meta = self.meta
        s = self.settings
        S = meta.num_subdomains
        Sp = self.S_local
        dtype = s.value_dtype
        dev = self.device
        n_hist = s.max_iters + 1

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        x_own = (zeros(Sp, meta.max_interior) if x0 is None
                 else torch.as_tensor(np.asarray(x0)[self._sub], dtype=dtype,
                                      device=dev).clone())
        return {
            "x_own": x_own,
            "x_ext": zeros(Sp, meta.max_ext),
            "z": zeros(Sp, meta.max_rows),
            "local_rn0": -torch.ones(Sp, dtype=dtype, device=dev),
            "conv": init_conv_state(S, dtype, dev),
            "nconv": 0,
            "grn": zeros(),
            "diverged": False,
            "it": 0,
            "it_stop": s.max_iters,
            "hist_local": zeros(n_hist, Sp),
            "hist_global": zeros(n_hist),
            "hist_inner": zeros(n_hist, Sp, dt=torch.int32),
            "hist_inner_rel": zeros(n_hist, Sp),
        }

    def neighbor_locality(self) -> np.ndarray:
        """(S, S) bool: True where the two subdomains' ranks live in one
        process (the reference's check_subd_locality, utils.cpp:52-66, via
        MPI_Comm_split_type(SHARED); ``schwarz_tpu/ras.py:2271-2279``).
        Without a mesh every rank lives on one card: all True."""
        S = self.meta.num_subdomains
        if self.mesh is None:
            return np.ones((S, S), dtype=bool)
        proc = np.asarray(self.mesh.process_of)[np.arange(S) // self.Sl]
        return proc[:, None] == proc[None, :]

    def set_rhs(self, rhs) -> None:
        """Re-target the solver at a new right-hand side of the same
        operator (``schwarz_tpu/ras.py:433-464``).  The decomposition, the
        factors, the preconditioner, the coarse space and the plan stay;
        ``local_rhs`` and ``global_rhs`` are replaced.  Under
        ``comm.overlap_split`` the hoisted ``z_base`` is recomputed from
        the new rhs (the JAX package keeps the old one, and its split
        solve then iterates towards the old system)."""
        dec = self.dec
        N = dec.meta.global_size
        rhs = np.asarray(rhs).reshape(-1)
        if rhs.shape[0] != N:
            raise ValueError(
                f"rhs has {rhs.shape[0]} entries, operator has {N} rows")
        rhs_p = rhs.astype(np.float64)[dec.perm]
        local_rhs = np.zeros_like(dec.local_rhs)
        for p in range(dec.meta.num_subdomains):
            rc = int(dec.rows_count[p])
            local_rhs[p, :rc] = rhs_p[dec.local_to_global[p, :rc]]
        dec.local_rhs = local_rhs
        dec.global_rhs = rhs_p.astype(dec.global_rhs.dtype)
        self._plan["local_rhs"] = torch.from_numpy(self._local_rows(
            local_rhs.astype(np.dtype(self.settings.dtype)))).to(self.device)
        if self._overlap_split:
            self._plan["z_base"] = self._split_z_base()

    # ------------------------------------------------------------ checkpoints --
    def save_checkpoint(self, state: Dict[str, Any], path: str) -> None:
        """Write a solver state (iterate, counters, histories) as the JAX
        package's ``.npz``: ``arr_i`` in its ``jax.tree.flatten`` order
        (:data:`STATE_KEYS`), so either package resumes the other's.
        Across processes every leaf is gathered whole (:data:`SUBD_AXIS`)
        and process 0 writes the file."""
        flat = []
        for k in STATE_KEYS:
            v = state[k]
            if k == "conv":
                flat += [t.cpu().numpy() for t in v]
            elif k in _HOST_SCALARS:
                flat.append(np.asarray(_HOST_SCALARS[k](v)))
            elif k in SUBD_AXIS:
                flat.append(self._global(v, SUBD_AXIS[k]))
            else:
                flat.append(v.cpu().numpy())
        write_once(self._mesh, lambda: np.savez_compressed(path, *flat))

    def load_checkpoint(self, path: str) -> Dict[str, Any]:
        """A state saved by :meth:`save_checkpoint` (or by the JAX
        package), by any number of processes: each process keeps its block
        of the subdomains.  History arrays are re-fitted when this solver's
        ``max_iters`` differs from the writer's (resume with a larger
        budget)."""
        template = self.init_state()
        leaves, axes = [], []
        for k in STATE_KEYS:
            v = template[k]
            leaves += list(v) if k == "conv" else [v]
            axes += ([None] * len(v) if k == "conv"
                     else [SUBD_AXIS.get(k)])
        with np.load(path) as data:
            arrs = [np.asarray(data[f"arr_{i}"]) for i in range(len(leaves))]
        arrs = [a if ax is None else cut(self._mesh, a, ax)
                for a, ax in zip(arrs, axes)]
        loaded = []
        for i, (arr, tmpl) in enumerate(zip(arrs, leaves)):
            t = (tmpl.cpu().numpy() if isinstance(tmpl, torch.Tensor)
                 else np.asarray(tmpl))
            if arr.shape != t.shape:
                if arr.ndim != t.ndim or arr.shape[1:] != t.shape[1:]:
                    raise ValueError(
                        f"checkpoint leaf {i} shape {arr.shape} "
                        f"incompatible with {t.shape}")
                n = min(arr.shape[0], t.shape[0])
                t = t.copy()
                t[:n] = arr[:n]
                arr = t
            if isinstance(tmpl, torch.Tensor):
                # np.array, not np.ascontiguousarray: that lifts a 0-d
                # leaf to shape (1,)
                loaded.append(torch.from_numpy(np.array(arr)).to(
                    tmpl.dtype).to(self.device))
            else:
                loaded.append(type(tmpl)(arr[()]))
        st = {}
        n_conv = len(ConvState._fields)
        pos = 0
        for k in STATE_KEYS:
            if k == "conv":
                st[k] = ConvState(*loaded[pos:pos + n_conv])
                pos += n_conv
            else:
                st[k] = loaded[pos]
                pos += 1
        return st

    def run(self, x0: Optional[np.ndarray] = None,
            resume_state: Optional[Dict[str, Any]] = None,
            checkpoint_path: Optional[str] = None,
            chunk_iters: Optional[int] = None) -> RASResult:
        """Solve; returns the solution in the original row ordering plus
        the true-residual oracle (cf. SchwarzBase::run +
        compute_residual_norm).

        ``resume_state`` (from :meth:`load_checkpoint`) continues a
        partially converged solve; ``checkpoint_path`` saves the final
        state for later resumption; ``write_debug_out`` saves it to
        ``schwarz_debug_out.npz`` in the working directory.
        ``chunk_iters`` caps the outer iterations per chunk (``it_stop``);
        results equal the unchunked run."""
        S = self.meta.num_subdomains
        max_iters = self.settings.max_iters
        if resume_state is not None:
            # the steps write into the state's tensors: work on a copy
            st = {k: (ConvState(*(t.clone() for t in v)) if k == "conv"
                      else v.clone() if isinstance(v, torch.Tensor) else v)
                  for k, v in resume_state.items()}
        else:
            st = self.init_state(x0)
        # a resumed state carries the previous run's stop marker
        st["it_stop"] = max_iters
        t0 = time.perf_counter()
        while True:
            if chunk_iters is not None:
                st["it_stop"] = min(st["it"] + chunk_iters, max_iters)
            # the reference loop bound (schwarz_base.cpp:387): at most
            # max_iters local solves; the detecting pass does not solve
            while (st["it"] < max_iters and st["it"] < st["it_stop"]
                   and st["nconv"] < S and not st["diverged"]):
                st = self._step(st)
            if self.settings.enable_logging:
                print(f"[schwarz_tpu_torch] it={st['it']} "
                      f"nconv={st['nconv']}/{S} grn={float(st['grn']):.6e}",
                      file=sys.stderr, flush=True)
            if (chunk_iters is None or st["nconv"] >= S or st["diverged"]
                    or st["it"] >= max_iters):
                break
        x_own = self._global(st["x_own"])
        elapsed = time.perf_counter() - t0
        if checkpoint_path is not None:
            self.save_checkpoint(st, checkpoint_path)
        if self.settings.write_debug_out:
            # the reference's write_debug_out role (settings.hpp:127-207):
            # the whole final solver state
            self.save_checkpoint(st, "schwarz_debug_out.npz")

        it = st["it"]
        converged = st["nconv"] >= S and not st["diverged"]
        iters = it - 1 if converged else it
        # histories hold rows 0..it-1 (the detecting pass is the last one)
        return self._assemble_result(
            x_own, converged, st["diverged"], iters,
            self._global(st["hist_local"][:it], axis=1),
            st["hist_global"][:it].cpu().numpy(),
            self._global(st["hist_inner"][:it], axis=1),
            elapsed,
        )

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_instrumented(self, x0: Optional[np.ndarray] = None) -> RASResult:
        """Solve with per-stage host timing (measurement mode;
        ``schwarz_tpu/ras.py:1941-2042``).

        :meth:`run` with each stage of :meth:`_build_stage_fns` timed on
        the host clock, the device synchronized inside the timed block, so
        a sample is the stage's time and not its launch time; the loop,
        and so every result, is ``run()``'s.  Covers the configured
        exchange strategy and ``two_level`` (its ``coarse_correction`` and
        ``residual_recompute`` stages, and the second exchange and update
        timed under the first ones' names).  The stale-halo modes
        (``overlap_comm``, onesided staleness > 1) raise, as in the JAX
        package.  ``result.stage_timings`` holds ``{stage: {total, avg,
        min, med, max, count}}`` in seconds."""
        s = self.settings
        if s.comm.overlap_comm or (s.comm.onesided and s.comm.staleness > 1):
            raise ValueError(
                "run_instrumented requires fresh halos each iteration; the "
                "stale-halo modes (enable_overlap / onesided staleness) "
                "carry cross-iteration halo state — run them with run()")
        timer = StageTimer()

        def timed(name, fn):
            def stage(*args):
                with timer.time(name):
                    out = fn(*args)
                    self._synchronize()
                return out
            return stage

        stages = self._stages
        self._stages = {k: timed(k, f) for k, f in stages.items()}
        try:
            result = self.run(x0)
        finally:
            self._stages = stages
        result.stage_timings = timer.summary()
        return result

    def _assemble_result(
        self, x_own, converged, diverged, iters, hist_l, hist_g, hist_i,
        elapsed,
    ) -> RASResult:
        """Solution in the original ordering and the true residual, in
        float64 on the host against the global matrix."""
        dec = self.dec
        S = self.meta.num_subdomains
        N = self.meta.global_size
        x_perm = np.zeros(N, dtype=x_own.dtype)
        for p in range(S):
            lo, hi = dec.first_row[p], dec.first_row[p + 1]
            x_perm[lo:hi] = x_own[p, : hi - lo]
        x_orig = np.zeros_like(x_perm)
        x_orig[dec.perm] = x_perm
        A = dec.global_matrix.to_scipy()
        resid = dec.global_rhs.astype(np.float64) - A @ x_perm.astype(
            np.float64)
        rhs_norm = float(np.linalg.norm(dec.global_rhs.astype(np.float64)))
        res_norm = float(np.linalg.norm(resid))
        return RASResult(
            solution=x_orig,
            converged=converged,
            diverged=diverged,
            iters=iters,
            residual_norm=res_norm,
            relative_residual_norm=res_norm / max(rhs_norm, 1e-300),
            local_resnorm_history=hist_l,
            global_resnorm_history=hist_g,
            inner_iters_history=hist_i,
            solve_time_s=elapsed,
            comm_matrix=dec.comm_matrix,
        )

    # ------------------------------------------------- Krylov acceleration --
    def _accel_closures(self):
        """The global FGMRES's operator and RAS preconditioner on the
        interior layout (S, R_int): each one exchange (K2), the operator
        through K1 plus the interface couplings, the preconditioner one
        local solve from a zero start plus the coarse correction."""
        plan = self._plan
        S, R_rows = self.S_local, self.meta.max_rows
        dtype = self.settings.value_dtype

        def matvec(v):
            v_ext = self._exchange(v)
            av = self._apply_local()(v_ext[:, :R_rows])
            # interface couplings scattered onto their rows: with overlap 1
            # interior rows carry interface entries, and dropping them would
            # make the operator block-diagonal
            av = _interface_scatter(plan, _interface_contrib(plan, v_ext), av)
            # the card is idle at the caller's host read anyway
            self._drain_shifts()
            return self._extract_int(av)

        def precond(r):
            r_ext = self._exchange(r)
            z, _, _ = self._local_solve(
                r_ext[:, :R_rows],
                torch.zeros((S, R_rows), dtype=dtype, device=self.device))
            mr = self._extract_int(z)
            if self.settings.two_level:
                mask = plan["interior_mask"]
                cfield = coarse_correct(plan, torch.where(
                    mask, r, torch.zeros_like(r)), self._mesh)
                mr = mr + torch.where(mask, cfield, torch.zeros_like(cfield))
            return mr

        return matvec, precond

    def run_accelerated(self, x0: Optional[np.ndarray] = None,
                        resume_state=None,
                        checkpoint_path: Optional[str] = None,
                        chunk_iters: Optional[int] = None,
                        instrument: bool = False) -> RASResult:
        """Solve the global system by flexible GMRES preconditioned by one
        RAS application (``schwarz_tpu/ras.py:2112-2211``): ``restart_iter``
        is the Krylov restart, ``tolerance`` the relative-residual target,
        and the configured local solver, preconditioner, exchange strategy
        and coarse space make up the preconditioner.

        ``chunk_iters`` caps the Krylov iterations per chunk, rounded up to
        restart cycles (results equal the unchunked run);
        ``checkpoint_path`` saves the resumable cycle state as the JAX
        package's six-leaf ``.npz``; ``resume_state`` (from
        :meth:`load_accel_checkpoint`) continues it.  ``instrument`` adds
        ``stage_timings`` for ``accel_matvec`` and ``accel_precond``
        (:meth:`_accel_stage_timings`)."""
        s = self.settings
        dec = self.dec
        S, R_int = self.meta.num_subdomains, self.meta.max_interior
        dtype = np.dtype(s.dtype)
        m = max(s.restart_iter, 2)
        max_cycles = -(-s.max_iters // m)
        budget = None if chunk_iters is None else max(1, -(-chunk_iters // m))
        matvec, precond = self._accel_closures()

        b_own = np.zeros((S, R_int), dtype)
        for p in range(S):
            lo, hi = dec.first_row[p], dec.first_row[p + 1]
            b_own[p, : hi - lo] = dec.global_rhs[lo:hi]
        b_dev = torch.from_numpy(self._local_rows(b_own)).to(self.device)
        bnorm = float(np.linalg.norm(b_own))

        t0 = time.perf_counter()
        # a carry (resumed, or the previous chunk's) overrides the start
        carry = resume_state
        if carry is not None:
            x_start = carry[0]
        elif x0 is None:
            x_start = torch.zeros((self.S_local, R_int), dtype=s.value_dtype,
                                  device=self.device)
        else:
            x_start = torch.as_tensor(np.asarray(x0)[self._sub],
                                      dtype=s.value_dtype, device=self.device)
        psum = None if self._mesh is None else self._mesh.psum
        while True:
            carry = fgmres(matvec, precond, b_dev, x_start, s.tolerance,
                           s.max_iters, m, state=carry,
                           cycle_budget=budget, psum=psum).state
            if budget is None or not carry[4] or int(carry[3]) >= max_cycles:
                break
        x = self._global(carry[0])
        elapsed = time.perf_counter() - t0

        if checkpoint_path is not None:
            _, rnorm, it, cycles, active, hist = carry
            write_once(self._mesh, lambda: np.savez_compressed(
                checkpoint_path, x, np.asarray(rnorm),
                np.asarray(it, np.int32), np.asarray(cycles, np.int32),
                np.asarray(active, np.bool_), np.asarray(hist)))
        iters = int(carry[2])
        rel_v = float(carry[1]) / max(bnorm, 1e-300)
        hist_g = np.asarray(carry[5])[: iters + 1]
        result = self._assemble_result(
            x, rel_v <= s.tolerance, bool(np.isnan(rel_v)), iters,
            np.zeros((len(hist_g), S)), hist_g,
            np.zeros((len(hist_g), S), np.int32), elapsed)
        if instrument:
            result.stage_timings = self._accel_stage_timings(
                matvec, precond, b_dev)
        return result

    def _accel_stage_timings(self, matvec, precond, b_dev) -> dict:
        """Per-stage attribution for the accelerated mode
        (``schwarz_tpu/ras.py:2236-2269``): the operator and the RAS
        preconditioner, each applied to ``b`` once to warm up and then
        timed ten times on the host clock, synchronized."""
        timings = {}
        for name, fn in (("accel_matvec", matvec), ("accel_precond", precond)):
            fn(b_dev)
            self._synchronize()
            samples = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn(b_dev)
                self._synchronize()
                samples.append(time.perf_counter() - t0)
            samples.sort()
            timings[name] = {
                "total": sum(samples), "avg": sum(samples) / len(samples),
                "min": samples[0], "med": samples[len(samples) // 2],
                "max": samples[-1],
            }
        return timings

    def load_accel_checkpoint(self, path: str):
        """A resumable FGMRES cycle state saved by ``checkpoint_path`` (by
        either package, in any number of processes); its iterate cut to
        this process's subdomains."""
        with np.load(path) as data:
            leaves = [np.asarray(data[f"arr_{i}"]) for i in range(6)]
        x = torch.from_numpy(np.ascontiguousarray(
            self._local_rows(leaves[0]))).to(
            self.settings.value_dtype).to(self.device)
        return (x, leaves[1][()], np.int32(leaves[2]), np.int32(leaves[3]),
                np.bool_(leaves[4]), leaves[5])


def _tier_2d_applies(mat, px: int, py: int, overlap: int, oras_c: float,
                     num_ranks: Optional[int]) -> bool:
    """Whether the 2-D tier accepts this operator: the checks that
    ``AsyncRASolver2D`` makes before it builds anything (overlap bound,
    structural gates of the plan, O-RAS range, rank tiling)."""
    try:
        async_ras_2d.check_overlap(overlap)
        async_ras_2d.grid_stencil(mat)
        if oras_c:
            async_ras_2d.check_oras_weight(oras_c)
        if num_ranks is not None:
            async_ras_2d.rank_grid(num_ranks, px, py)
    except (NotImplementedFeature, ValueError):
        return False
    return True


def free_running_tier(mat, num_subdomains: int, settings: Settings,
                      partition_indices=None, num_ranks=None,
                      oras_c: float = 0.0) -> str:
    """The free-running tier the JAX package's dispatch chain picks
    (``schwarz_tpu/ras.py:2451-2502``): "2d" (block grid, K6), "1d" (banded
    strips, K5) or "general" (any graph, K7), tried in that order."""
    S = num_subdomains
    if partition_indices is None and settings.partition in (
            Partition.regular, Partition.regular2d):
        py = max((d for d in range(2, int(S ** 0.5) + 1) if S % d == 0),
                 default=None)
        if py is not None and _tier_2d_applies(
                mat, S // py, py, settings.overlap, oras_c, num_ranks):
            return "2d"
        try:
            plan_geometry(mat, S, settings.overlap)
            return "1d"
        except NotImplementedFeature:
            pass
    return "general"


def make_free_running_solver(mat, rhs, num_subdomains, settings,
                             partition_indices=None, num_ranks=None,
                             ninner=None, chunk_rounds=16,
                             fresh_read=None, device=None, mesh=None):
    """Pick the free-running kernel for this matrix and partition, as the
    JAX package's ``make_free_running_solver`` does.

    Dispatch chain: the 2-D block-grid tier (K6), the 1-D banded tier (K5),
    the general-graph tier (K7), which takes any matrix and any partition.
    ``num_ranks`` takes the place of the JAX package's mesh: the number of
    asynchronous ranks, one per subdomain by default.  ``mesh`` deals the
    ranks to the processes of a group (its rank count is the tier's), and
    every tier then runs across them.

    Returns ``(solver, refine)``: ``refine`` says the caller should use
    ``run_refined(tol=settings.tolerance)``, because the tolerance sits
    below the f32 in-band floor or ``two_level`` is set.
    """
    nonsym = bool(settings.non_symmetric_matrix)
    if settings.accelerator != "none":
        raise NotImplementedFeature(
            "free-running mode is the stationary asynchronous iteration; "
            "Krylov acceleration requires the synchronous run_accelerated"
        )
    if settings.precond not in (Precond.none, Precond.jacobi):
        raise NotImplementedFeature(
            "free-running kernels run in-kernel Jacobi-preconditioned "
            "correction solves; block_jacobi/fsai preconditioning requires "
            "the synchronous path"
        )
    oras_c = oras_weight(settings)

    S = num_subdomains
    if mesh is not None:
        num_ranks = mesh.num_ranks
    if ninner is None:
        ninner = (settings.local_max_iters
                  if settings.local_max_iters > 0 else 16)
    if fresh_read is None:
        fresh_read = settings.comm.fresh_read
    # below the f32 kernels' reachable relative tolerance, iterative-
    # refinement restarts; two_level's coarse solves live at the restarts
    refine = settings.tolerance < F32_TOL_FLOOR or settings.two_level
    inner_tol = 1e-4 if refine else settings.tolerance
    if settings.two_level:
        inner_tol = max(
            inner_tol, 1e-1 if settings.coarse_aggregates >= 16 else 1e-2
        )
    staleness = max(settings.comm.staleness, 1)

    tier = free_running_tier(mat, S, settings, partition_indices,
                             num_ranks, oras_c)
    if tier == "2d":
        py = max(d for d in range(2, int(S ** 0.5) + 1) if S % d == 0)
        return async_ras_2d.AsyncRASolver2D(
            mat, rhs, px=S // py, py=py, tolerance=inner_tol,
            staleness=staleness, ninner=ninner, chunk_rounds=chunk_rounds,
            num_ranks=num_ranks, device=device, fresh_read=fresh_read,
            oras_weight=oras_c, nonsym=nonsym, overlap=settings.overlap,
            mesh=mesh,
        ), refine
    if tier == "general":
        if fresh_read:
            raise NotImplementedFeature(
                "fresh_read (freshest-arrived semaphore peeks) is "
                "implemented in the 1-D/2-D free-running kernels only; the "
                "general-graph kernel consumes the staleness-bound slot — "
                "unset fresh_read for unstructured/custom-partition "
                "free-running solves"
            )
        part = partition_indices
        if part is None and settings.partition != Partition.regular:
            part = make_partition(mat, S, settings)
        return AsyncGeneralRASolver(
            mat, rhs, num_subdomains=S, overlap=settings.overlap,
            tolerance=inner_tol, staleness=staleness, ninner=ninner,
            chunk_rounds=chunk_rounds, part=part, num_ranks=num_ranks,
            device=device, oras_weight=oras_c, nonsym=nonsym, mesh=mesh,
        ), refine
    return AsyncRASolver(
        mat, rhs, num_subdomains=S, overlap=settings.overlap,
        tolerance=inner_tol, staleness=staleness, ninner=ninner,
        chunk_rounds=chunk_rounds, num_ranks=num_ranks, device=device,
        fresh_read=fresh_read, oras_weight=oras_c, nonsym=nonsym, mesh=mesh,
    ), refine


def _solve_free_running(mat, rhs, settings, S, partition_indices,
                        num_ranks, device, mesh=None) -> RASResult:
    """The free-running branch of :func:`solve` (``schwarz_tpu/ras.py:
    2532-2558``): the RASResult carries no histories."""
    fr, refine = make_free_running_solver(
        mat, rhs, S, settings, partition_indices=partition_indices,
        num_ranks=num_ranks, device=device, mesh=mesh)
    if refine:
        x, info = fr.run_refined(
            tol=settings.tolerance, max_rounds=settings.max_iters,
            coarse_q=(max(1, settings.coarse_aggregates)
                      if settings.two_level else 0),
        )
    else:
        x, info = fr.run(max_rounds=settings.max_iters)
    rel = info["relative_residual_norm"]
    rn = rel * float(np.linalg.norm(np.asarray(rhs)))
    return RASResult(
        solution=x, converged=info["converged"], diverged=False,
        iters=int(max(info["done_at"].max(), 0)),
        residual_norm=rn, relative_residual_norm=rel,
        local_resnorm_history=np.zeros((0, S)),
        global_resnorm_history=np.zeros(0),
        inner_iters_history=np.zeros((0, S), np.int32),
        solve_time_s=info["time_s"],
        comm_matrix=np.zeros((S, S)),
    )


def solve(
    mat,
    rhs,
    settings: Settings = Settings(),
    num_subdomains: Optional[int] = None,
    device=None,
    partition_indices: Optional[np.ndarray] = None,
    cell_weights: Optional[np.ndarray] = None,
    num_ranks: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> RASResult:
    """One-call API: decompose + setup + run (cf. bench_ras.cpp:161-180).

    ``mat`` may be a :class:`~schwarz_tpu_torch.models.CSRMatrix` or any
    scipy-sparse-convertible matrix.  Runs on CUDA unless ``device`` names
    another device; raises when there is no GPU and no device is given.
    ``settings.free_running`` takes the free-running asynchronous path
    (:func:`make_free_running_solver`), ``accelerator='fgmres'`` the
    Krylov-accelerated one (:meth:`RASolver.run_accelerated`).  ``num_ranks`` stands where the JAX
    package takes a device mesh: the ranks the subdomains are dealt to, one
    per subdomain by default; it must divide ``num_subdomains``.  ``mesh``
    deals them to the processes of a group instead (every process calls
    ``solve`` with the same inputs and gets the same result);
    ``num_subdomains`` then defaults to its rank count, the role of
    ``len(jax.devices())`` in the JAX package.
    """
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import CSRMatrix

    if mesh is not None:
        if num_subdomains is None:
            num_subdomains = mesh.num_ranks
        if device is None:
            device = mesh.device
        if num_ranks is None:
            num_ranks = mesh.num_ranks
    device = resolve_device(device)
    if not isinstance(mat, CSRMatrix) and hasattr(mat, "tocsr"):
        mat = CSRMatrix.from_scipy(mat)
    if settings.free_running:
        return _solve_free_running(mat, rhs, settings, num_subdomains or 1,
                                   partition_indices, num_ranks, device,
                                   mesh)
    dec = decompose(
        mat, rhs, settings, num_subdomains or 1, partition_indices,
        cell_weights=cell_weights,
    )
    solver = RASolver(dec, device=device, num_ranks=num_ranks, mesh=mesh)
    if settings.accelerator == "fgmres":
        return solver.run_accelerated()
    return solver.run()
