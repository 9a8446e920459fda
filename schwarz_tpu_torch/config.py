"""Configuration: the port's copy of ``schwarz_tpu/config.py``.

Same enums, dataclasses, field names and defaults as the JAX package (the
reference's Settings / Metadata structs, include/settings.hpp:77-496), so a
configuration carries over unchanged.  ``value_dtype`` and
``halo_value_dtype`` return torch dtypes.  Which knobs this slice honours is
checked where they are read: :class:`schwarz_tpu_torch.ras.RASolver` raises
``NotImplementedFeature`` for settings whose path is not ported yet.  The
field comments here are short; ``schwarz_tpu/config.py`` documents each knob.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Partition(enum.Enum):
    """Partitioning strategy (reference include/settings.hpp:94-102)."""

    regular = "regular"          # contiguous 1-D row blocks
    regular2d = "regular2d"      # square grid blocks (5-pt Laplacian domains)
    metis = "metis"              # graph partition
    custom = "custom"            # user-provided partition_indices


class LocalSolver(enum.Enum):
    """Local subdomain solver (reference include/settings.hpp:142-151)."""

    iterative_cg = "cg"
    iterative_gmres = "gmres"
    direct_cholesky = "cholesky"
    direct_lu = "lu"


class Precond(enum.Enum):
    """Local preconditioner (reference solve.cpp:490-556)."""

    none = "none"
    jacobi = "jacobi"
    block_jacobi = "block_jacobi"
    fsai = "fsai"
    ilu = "ilu"


class HaloStrategy(enum.Enum):
    """How halo values of the iterate travel between subdomains."""

    all_gather = "all_gather"
    neighbor = "neighbor"
    rdma = "rdma"


class GlobalConvergence(enum.Enum):
    """Global convergence detection (reference C16-C19)."""

    allgather = "allgather"
    allreduce = "allreduce"
    tree = "tree"
    decentralized = "decentralized"


class LocalCriterion(enum.Enum):
    """Local update form (reference settings.hpp:282-288): solution_based
    overwrites the interior slice each iteration; residual_based adds a
    correction."""

    solution_based = "solution_based"
    residual_based = "residual_based"


@dataclasses.dataclass(frozen=True)
class CommSettings:
    """Communication settings (reference include/settings.hpp:217-268)."""

    onesided: bool = False
    overlap_comm: bool = False         # <- comm_settings.enable_overlap
    overlap_split: bool = False        # exact comm/compute split of the solve
    strategy: HaloStrategy = HaloStrategy.all_gather
    staleness: int = 0                 # halo age in iterations (async emulation)
    fresh_read: bool = False           # free-running mode only
    enable_put: bool = False
    enable_get: bool = True
    enable_one_by_one: bool = False
    flush_type: str = "flush-all"
    lock_type: str = "lock-all"
    stage_through_host: bool = False


@dataclasses.dataclass(frozen=True)
class ConvergenceSettings:
    """Convergence detection settings (reference include/settings.hpp:273-290)."""

    method: GlobalConvergence = GlobalConvergence.allgather
    criterion: LocalCriterion = LocalCriterion.solution_based
    put_all_local_residual_norms: bool = True
    enable_accumulate: bool = False
    # delay global checks for the first 5% of max_iters (solve.cpp:992-996)
    enable_global_check_iter_offset: bool = False


@dataclasses.dataclass(frozen=True)
class Settings:
    """All user-tunable knobs (reference include/settings.hpp:77-305)."""

    partition: Partition = Partition.regular
    overlap: int = 2                         # MINIMAL_OVERLAP (settings.hpp:64,108)
    local_solver: LocalSolver = LocalSolver.iterative_cg
    non_symmetric_matrix: bool = False
    restart_iter: int = 30                   # GMRES restart (settings.hpp:161)
    reset_local_crit_iter: int = -1          # (settings.hpp:166)
    precond: Precond = Precond.none
    block_jacobi_block_size: int = 16
    ilu_sweeps: int = 3
    max_iters: int = 100                     # outer iterations (bench_base.hpp:55)
    tolerance: float = 1e-6                  # outer rel. residual (bench_base.hpp:54)
    local_tolerance: float = 1e-12           # inner reduction factor (bench_base.hpp:56)
    local_max_iters: int = -1                # -1: local_size_x (solve.cpp:723-728)
    direct_apply: str = "trisolve"
    comm: CommSettings = dataclasses.field(default_factory=CommSettings)
    convergence: ConvergenceSettings = dataclasses.field(
        default_factory=ConvergenceSettings)
    dtype: str = "float64"                   # value dtype (settings.hpp:526-537)
    halo_dtype: Optional[str] = None         # None = same as dtype
    # dtype of the local solves (iterative refinement); None = same as dtype
    local_compute_dtype: Optional[str] = None
    metis_objtype: str = "edgecut"           # (settings.hpp:176)
    debug_print: bool = False
    print_matrices: bool = False
    write_debug_out: bool = False
    write_iters_and_residuals: bool = False
    enable_logging: bool = False
    shifted_iter: bool = False               # dead in the reference; True raises
    row_pad_multiple: int = 8                # padding multiple of subdomain rows
    # local operator storage: "dia" (diagonals + ELL remainder), "ell", or
    # "auto" = dia on the card when diagonals hold >= 50% of the nonzeros
    spmv_format: str = "auto"
    dia_max_diags: int = 16
    inner_operator: str = "exact"            # "exact" or "dia_only"
    # kept for parity with the JAX package: on the card the port's DIA
    # kernel and halo kernel always run
    use_pallas: str = "auto"
    halo_fused: str = "auto"
    # the whole local CG in one kernel launch (K3, ops/fused_cg.py) on any
    # device, or raise; a plan on the card takes K3 whenever its gate holds
    fused_local_cg: bool = False
    oras_weight: object = 0.0                # float, or the string "auto"
    two_level: bool = False
    coarse_aggregates: int = 1
    coarse_space: str = "aggregates"
    coarse_solver: str = "dense"
    accelerator: str = "none"
    free_running: bool = False

    @property
    def value_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def halo_value_dtype(self) -> torch.dtype:
        return getattr(torch, self.halo_dtype) if self.halo_dtype else self.value_dtype

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Metadata:
    """Static, derived description of a decomposed problem (the immutable
    subset of the reference Metadata, include/settings.hpp:318-496).  Sizes
    are the padded sizes shared by all subdomains."""

    global_size: int
    num_subdomains: int
    overlap: int
    max_interior: int       # padded interior rows   (metadata.local_size)
    max_rows: int           # padded interior+overlap (metadata.local_size_x)
    max_ext: int            # padded interior+overlap+ghost ring
    ell_width_local: int    # ELL nnz/row of padded local matrices
    ell_width_interface: int
    nnz_global: int

    def __post_init__(self):
        if not self.max_interior <= self.max_rows <= self.max_ext:
            raise ValueError(
                f"inconsistent padded sizes: {self.max_interior}, "
                f"{self.max_rows}, {self.max_ext}")
