"""Indexed gather/scatter with combine modes: the port of
``schwarz_tpu/ops/gather_scatter.py`` as plain torch ops (reference C23:
include/gather.hpp:47-153, include/scatter.hpp, source/gather_kernel.cu /
scatter_kernel.cu), where ``gather: into[i] op= from[idx[i]]`` and
``scatter: into[idx[i]] op= from[i]`` with ``op in {copy, add, diff, avg}``
(include/collective_common.hpp:37).

Both return a new tensor and leave ``into_arr`` as it was, as the JAX
functions do.  ``avg`` matches the reference's definition:
``(old + new) / 2``.  No solver path calls them; they are public API.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch


class GatherOp(enum.Enum):
    copy = "copy"
    add = "add"
    diff = "diff"
    avg = "avg"


def _first_axis_mask(n: int, num: int, like: torch.Tensor) -> torch.Tensor:
    """(n, 1, ...) bool: True for the first ``num`` entries along axis 0."""
    mask = torch.arange(n, device=like.device) < num
    return mask.reshape((n,) + (1,) * (like.ndim - 1))


def gather_values(
    num: Optional[int],
    idx: torch.Tensor,
    from_arr: torch.Tensor,
    into_arr: torch.Tensor,
    op: GatherOp = GatherOp.copy,
) -> torch.Tensor:
    """into[i] op= from[idx[i]] for i < num (reference gather.hpp:82-114).

    ``num`` may be None to use the whole index array; with ``num`` given,
    entries beyond it are left unchanged.
    """
    vals = from_arr[idx]
    n = idx.shape[0]
    cur = into_arr[:n]
    if op == GatherOp.copy:
        new = vals
    elif op == GatherOp.add:
        new = cur + vals
    elif op == GatherOp.diff:
        new = cur - vals
    else:
        new = (cur + vals) * 0.5
    if num is not None:
        new = torch.where(_first_axis_mask(n, num, new), new, cur)
    out = into_arr.clone()
    out[:n] = new
    return out


def scatter_values(
    num: Optional[int],
    idx: torch.Tensor,
    from_arr: torch.Tensor,
    into_arr: torch.Tensor,
    op: GatherOp = GatherOp.copy,
) -> torch.Tensor:
    """into[idx[i]] op= from[i] for i < num (reference scatter.hpp:82-120)."""
    n = idx.shape[0]
    vals = from_arr[:n]
    N_into = into_arr.shape[0]
    if num is not None:
        mask = _first_axis_mask(n, num, vals)
        # masked entries scatter to a scratch slot past the array end
        # (redirecting them to idx[0] would write a live slot twice, and
        # the order of duplicate writes is undefined)
        idx = torch.where(mask.reshape(n), idx, N_into)
        into_pad = torch.cat([into_arr, into_arr.new_zeros(
            (1,) + tuple(into_arr.shape[1:]))])
        if op in (GatherOp.add, GatherOp.diff):
            vals = torch.where(mask, vals, torch.zeros_like(vals))
    else:
        into_pad = into_arr.clone()
    if op == GatherOp.copy:
        into_pad[idx] = vals
    elif op == GatherOp.add:
        into_pad.index_add_(0, idx, vals)
    elif op == GatherOp.diff:
        into_pad.index_add_(0, idx, -vals)
    else:
        # avg: into[idx] = (into[idx] + from) / 2
        into_pad[idx] = (into_pad[idx] + vals) * 0.5
    return into_pad[:N_into]
