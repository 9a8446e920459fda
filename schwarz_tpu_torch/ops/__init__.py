"""Operators and the hand-written CUDA kernels (K1 ``dia_kernel``, K2
``halo_kernel``, K3 ``fused_cg``) with their plain PyTorch versions, plus
the indexed gather/scatter of the JAX package's public API."""

from schwarz_tpu_torch.ops.gather_scatter import (
    GatherOp,
    gather_values,
    scatter_values,
)

__all__ = [
    "gather_values",
    "scatter_values",
    "GatherOp",
]
