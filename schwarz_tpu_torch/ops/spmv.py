"""Sparse matrix-vector products in padded batched ELL format.

Port of ``schwarz_tpu/ops/spmv.py``: ``vals[s, r, w]``, ``cols[s, r, w]`` —
subdomain ``s``, row ``r``, ELL slot ``w``; padding slots carry value 0 with an
in-range column, so the product needs no mask.
"""

from __future__ import annotations

import torch


def ell_spmv_batched(vals: torch.Tensor, cols: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """(S, R, W) x (S, Rx) -> (S, R): y[s, r] = sum_w vals * x[s, cols]."""
    S, R, W = vals.shape
    gathered = torch.gather(x, 1, cols.reshape(S, R * W)).reshape(S, R, W)
    return torch.sum(vals * gathered, dim=-1)
