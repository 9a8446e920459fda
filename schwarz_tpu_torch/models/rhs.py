"""Right-hand-side generation (reference Initialize::generate_rhs,
source/initialization.cpp:89-96: uniform(0,1) with a fixed-seed engine; the
default non-random path uses a vector of ones, benchmarking/bench_ras.cpp rhs
setup with ``enable_random_rhs``)."""

from __future__ import annotations

import numpy as np


def generate_rhs(n: int, random: bool = True, seed: int = 0, dtype=np.float64):
    """Deterministic rhs: uniform(0,1) from a fixed seed, or ones."""
    if random:
        rng = np.random.default_rng(seed)
        return rng.uniform(0.0, 1.0, size=n).astype(dtype)
    return np.ones(n, dtype=dtype)
