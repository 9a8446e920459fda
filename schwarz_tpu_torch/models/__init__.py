"""Problem generators and matrix I/O: numpy copies of the JAX package's
``models/csr.py``, ``laplacian.py``, ``fem.py``, ``fem_assembly.py``,
``rhs.py`` and ``mtx.py``."""

from schwarz_tpu_torch.models.csr import CSRMatrix
from schwarz_tpu_torch.models.fem import (
    advection_diffusion_2d,
    anisotropic_diffusion_2d,
    helmholtz_2d,
    laplacian_3d,
)
from schwarz_tpu_torch.models.fem_assembly import (
    fem_p1_advection,
    fem_p1_elasticity,
    fem_p1_poisson,
)
from schwarz_tpu_torch.models.laplacian import laplacian_2d
from schwarz_tpu_torch.models.mtx import matrix_path, read_mtx, write_mtx
from schwarz_tpu_torch.models.rhs import generate_rhs

__all__ = [
    "CSRMatrix",
    "advection_diffusion_2d",
    "anisotropic_diffusion_2d",
    "laplacian_2d",
    "laplacian_3d",
    "helmholtz_2d",
    "fem_p1_poisson",
    "fem_p1_advection",
    "fem_p1_elasticity",
    "read_mtx",
    "write_mtx",
    "matrix_path",
    "generate_rhs",
]
