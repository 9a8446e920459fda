"""Problem generators and matrix I/O: numpy copies of the JAX package's
``models/csr.py``, ``laplacian.py``, ``fem.py``, ``rhs.py`` and ``mtx.py``
(``fem_assembly`` waits for a later slice)."""

from schwarz_tpu_torch.models.csr import CSRMatrix
from schwarz_tpu_torch.models.fem import (
    advection_diffusion_2d,
    anisotropic_diffusion_2d,
    laplacian_3d,
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
    "read_mtx",
    "write_mtx",
    "matrix_path",
    "generate_rhs",
]
