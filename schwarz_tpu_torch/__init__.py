"""schwarz_tpu_torch: the PyTorch / CUDA port of ``schwarz_tpu`` for an
NVIDIA H100.

A restricted additive Schwarz (RAS) solver for sparse ``A x = b`` with every
subdomain batched on one GPU.  Its hot path runs hand-written CUDA kernels
for Hopper (``csrc/``); each kernel's wrapper keeps a plain PyTorch version
that it uses for CPU tensors, so the package runs, slowly, on the CPU when
asked to (``device="cpu"``).  It imports neither JAX nor ``schwarz_tpu``.

    from schwarz_tpu_torch import Settings, laplacian_2d, generate_rhs, solve
    A = laplacian_2d(64)
    res = solve(A, generate_rhs(A.n), Settings(), num_subdomains=4)

``Settings(free_running=True)`` takes the free-running asynchronous path:
the 2-D block-grid tier (:class:`AsyncRASolver2D`) for grid stencils and a
composite subdomain count, else the 1-D banded tier (:class:`AsyncRASolver`),
else, for any matrix and any partition, the general-graph tier
(:class:`AsyncGeneralRASolver`).
"""

from schwarz_tpu_torch.config import (
    CommSettings,
    ConvergenceSettings,
    GlobalConvergence,
    HaloStrategy,
    LocalCriterion,
    LocalSolver,
    Metadata,
    Partition,
    Precond,
    Settings,
)
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.core.partition import (
    partition_metis,
    partition_regular_2d,
)
from schwarz_tpu_torch.exceptions import NotImplementedFeature, SchwarzError
from schwarz_tpu_torch.models import (
    CSRMatrix,
    advection_diffusion_2d,
    anisotropic_diffusion_2d,
    fem_p1_advection,
    fem_p1_elasticity,
    fem_p1_poisson,
    generate_rhs,
    laplacian_2d,
    laplacian_3d,
    read_mtx,
)
from schwarz_tpu_torch.ops.async_ras import AsyncRASolver, build_async_plan
from schwarz_tpu_torch.ops.async_ras_2d import (
    AsyncRASolver2D,
    build_async_plan_2d,
)
from schwarz_tpu_torch.ops.async_ras_general import (
    AsyncGeneralRASolver,
    build_general_plan,
)
from schwarz_tpu_torch.ras import (
    RASolver,
    RASResult,
    make_free_running_solver,
    solve,
)

__all__ = [
    "CommSettings",
    "ConvergenceSettings",
    "GlobalConvergence",
    "HaloStrategy",
    "LocalCriterion",
    "LocalSolver",
    "Metadata",
    "Partition",
    "Precond",
    "Settings",
    "NotImplementedFeature",
    "SchwarzError",
    "CSRMatrix",
    "advection_diffusion_2d",
    "anisotropic_diffusion_2d",
    "fem_p1_poisson",
    "fem_p1_advection",
    "fem_p1_elasticity",
    "generate_rhs",
    "laplacian_2d",
    "laplacian_3d",
    "read_mtx",
    "AsyncRASolver",
    "AsyncRASolver2D",
    "AsyncGeneralRASolver",
    "build_async_plan",
    "build_async_plan_2d",
    "build_general_plan",
    "partition_metis",
    "partition_regular_2d",
    "decompose",
    "RASolver",
    "RASResult",
    "make_free_running_solver",
    "solve",
]
