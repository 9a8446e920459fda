"""Operators and the hand-written CUDA kernels (K1 ``dia_kernel``, K2
``halo_kernel``, K3 ``fused_cg``) with their plain PyTorch versions."""
