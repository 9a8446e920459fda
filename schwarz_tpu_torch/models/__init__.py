"""Problem generators and matrix I/O: numpy copies of the JAX package's
``models/csr.py``, ``laplacian.py``, ``rhs.py`` and ``mtx.py`` (the FEM
generators wait for a later slice)."""

from schwarz_tpu_torch.models.csr import CSRMatrix
from schwarz_tpu_torch.models.laplacian import laplacian_2d
from schwarz_tpu_torch.models.mtx import matrix_path, read_mtx, write_mtx
from schwarz_tpu_torch.models.rhs import generate_rhs

__all__ = [
    "CSRMatrix",
    "laplacian_2d",
    "read_mtx",
    "write_mtx",
    "matrix_path",
    "generate_rhs",
]
