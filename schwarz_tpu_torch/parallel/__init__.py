"""Halo exchange and convergence detection for subdomains batched on one
device."""
