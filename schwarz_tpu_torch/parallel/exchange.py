"""Halo exchange: build the extended-local view ``x_ext`` of the iterate.

Port of ``schwarz_tpu/parallel/exchange.py``: the ``all_gather`` strategy
with every subdomain on one device, and the window insert plus halo scatter
(:func:`assemble_x_ext`) that the neighbour strategies
(``parallel/neighbor_exchange.py``) end in.  For ``all_gather`` the mesh
collective over the interior blocks becomes the ``(S, R_int)`` interior
array itself, viewed flat.  Each
subdomain's ``x_ext`` is its interior window plus its halo, which for
contiguous partitions is a handful of contiguous runs of the flat interior
array (:class:`RunPlan`).  The window insert is a torch scatter; the runs
are copied by kernel K2 (:func:`schwarz_tpu_torch.ops.halo_kernel.
assemble_runs`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.ops.halo_kernel import assemble_runs


@dataclasses.dataclass
class RunPlan:
    """Contiguous-run decomposition of the halo gather.

    Runs are grouped by length: class ``c`` holds (S, NR_c) start tables for
    runs of length ``lengths[c]``.  Unused entries carry dst = r_ext.
    """

    lengths: tuple            # (C,) static run lengths
    run_src: tuple            # C tables, each (S, NR_c) int32 flat starts
    run_dst: tuple            # C tables, each (S, NR_c) int32 slot starts


def build_run_plan(
    halo_src: np.ndarray,      # (S, H) flat indices into (S * R_int,)
    halo_slots: np.ndarray,    # (S, H) ext-slot indices (>= r_ext = padding)
    r_ext: int,
    r_int: int,
    interior_off: np.ndarray,  # (S,) unused (kept for signature parity)
    max_runs: int = 8,
    max_classes: int = 4,
) -> Optional[RunPlan]:
    """Detect the contiguous-run structure (grouped by run length), or None
    when too irregular (identical to the JAX package's detection)."""
    S, H = halo_src.shape
    per_sub = []
    for s in range(S):
        valid = halo_slots[s] < r_ext
        src = halo_src[s][valid]
        dst = halo_slots[s][valid]
        rs = []
        i = 0
        n = src.shape[0]
        while i < n:
            j = i + 1
            while (
                j < n
                and src[j] == src[j - 1] + 1
                and dst[j] == dst[j - 1] + 1
            ):
                j += 1
            rs.append((int(src[i]), int(dst[i]), j - i))
            i = j
        if len(rs) > max_runs:
            return None
        per_sub.append(rs)
    lengths = sorted({r[2] for rs in per_sub for r in rs})
    if not lengths:
        lengths = [1]
    if len(lengths) > max_classes:
        return None
    run_src, run_dst = [], []
    for L in lengths:
        nr = max(
            (sum(1 for r in rs if r[2] == L) for rs in per_sub), default=0
        )
        nr = max(nr, 1)
        tbl_s = np.zeros((S, nr), np.int32)
        tbl_d = np.full((S, nr), r_ext, np.int32)   # unused -> scratch pad
        for s in range(S):
            k = 0
            for (src0, dst0, ln) in per_sub[s]:
                if ln == L:
                    tbl_s[s, k] = src0
                    tbl_d[s, k] = dst0
                    k += 1
        run_src.append(tbl_s)
        run_dst.append(tbl_d)
    return RunPlan(lengths=tuple(int(x) for x in lengths),
                   run_src=tuple(run_src), run_dst=tuple(run_dst))


def flat_run_tables(
    run_plan: Optional[RunPlan],
    halo_src: np.ndarray,      # (S, H)
    halo_slots: np.ndarray,    # (S, H); r_ext = padding
    r_ext: int,
    n_all: int,                # S_total * R_int, the flat source length
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (src, dst, lens) table K2 takes: every length class of the run
    plan side by side, or — for an irregular halo with no run plan — one
    run of length 1 per halo element.  Checks that every used run lies
    inside the source and the ext row, which the kernel relies on."""
    if run_plan is None:
        src = np.asarray(halo_src, np.int32)
        dst = np.where(halo_slots < r_ext, halo_slots, r_ext).astype(np.int32)
        lens = np.ones(src.shape[1], np.int32)
    else:
        src = np.concatenate(run_plan.run_src, axis=1).astype(np.int32)
        dst = np.concatenate(run_plan.run_dst, axis=1).astype(np.int32)
        lens = np.concatenate([
            np.full(t.shape[1], L, np.int32)
            for L, t in zip(run_plan.lengths, run_plan.run_src)])
    used = dst < r_ext
    end_src = np.where(used, src.astype(np.int64) + lens, 0)
    end_dst = np.where(used, dst.astype(np.int64) + lens, 0)
    if ((used & (src < 0)).any() or (end_src > n_all).any()
            or (end_dst > r_ext).any() or (dst < 0).any()):
        raise ValueError("halo run table reaches outside its arrays")
    return (np.ascontiguousarray(src), np.ascontiguousarray(dst),
            np.ascontiguousarray(lens))


def window_insert(x_own: torch.Tensor, interior_off: torch.Tensor,
                  r_ext: int) -> torch.Tensor:
    """(S, r_ext + R_int) zeros with each interior block at its offset.

    The R_int spare columns keep every window in bounds; callers take
    ``[:, :r_ext]``."""
    S, r_int = x_own.shape
    buf = torch.zeros((S, r_ext + r_int), dtype=x_own.dtype,
                      device=x_own.device)
    cols = interior_off.to(torch.int64)[:, None] + torch.arange(
        r_int, device=x_own.device)
    return buf.scatter_(1, cols, x_own)


def assemble_x_ext(
    x_own: torch.Tensor,        # (S, R_int)
    interior_off: torch.Tensor,  # (S,)
    halo_slots: torch.Tensor,   # (S, H) int64; padding entries point at r_ext
    halo_vals: torch.Tensor,    # (S, H)
    r_ext: int,
) -> torch.Tensor:
    """Interior window first, then an element-wise scatter of the halo
    values (the form the neighbour strategies use: their values arrive in
    compact tables, not as runs of the flat interior).  Padding entries land
    in the spare column r_ext, which the returned (S, r_ext) view drops."""
    buf = window_insert(x_own, interior_off, r_ext)
    buf.scatter_(1, halo_slots, halo_vals.to(x_own.dtype))
    return buf[:, :r_ext]


def assemble_x_ext_runs(
    x_own: torch.Tensor,        # (S, R_int)
    x_all_flat: torch.Tensor,   # (S * R_int,) gathered interior blocks
    interior_off: torch.Tensor,  # (S,)
    run_tables,                 # (src, dst, lens) from flat_run_tables
    r_ext: int,
) -> torch.Tensor:
    """Interior window first, halo runs after (K2, in place) — the write
    order of the JAX package, so window-covered halo slots get their true
    values.  Returns an (S, r_ext) view with row stride r_ext + R_int."""
    buf = window_insert(x_own, interior_off, r_ext)
    assemble_runs(buf, x_all_flat, *run_tables, r_ext)
    return buf[:, :r_ext]


def exchange_halo_allgather(
    x_own: torch.Tensor,        # (S, R_int) every subdomain's interior
    interior_off: torch.Tensor,  # (S,)
    run_tables,                 # (src, dst, lens) device int32 tables
    r_ext: int,
    halo_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x_ext (S, r_ext) in the compute dtype.  With all subdomains on one
    device the all_gather is the interior array itself.

    With a ``halo_dtype`` the gathered blocks are rounded to it and cast
    back before the run copy (K2 moves bytes of one element size, so the
    casts sit around it; the values are those of a halo that travelled in
    ``halo_dtype``).  The subdomain's own interior window never passes
    through the reduced precision (restricted_schwarz.cpp:898-908)."""
    x_all = x_own
    if halo_dtype is not None:
        x_all = x_own.to(halo_dtype).to(x_own.dtype)
    return assemble_x_ext_runs(x_own, x_all.reshape(-1), interior_off,
                               run_tables, r_ext)
