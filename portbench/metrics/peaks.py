"""The published peaks of one NVIDIA H100 SXM and the roofline bound of a
launch: a frozen copy of ``chip_smoke.py:253-259`` (``HBM_BYTES_PER_S``,
``PEAK_OPS_PER_S``) and of its ``_bound_ms`` (``chip_smoke.py:271-275``),
returning seconds.  The benchmark's yardstick: kept here so that a change to
the smoke script cannot move a roofline share."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12            # device memory
PEAK_OPS_PER_S = {"float32": 67e12,  # outside the tensor cores
                  "float64": 34e12}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak rate of ``dtype``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype])
