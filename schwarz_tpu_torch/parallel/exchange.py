"""Halo exchange: build the extended-local view ``x_ext`` of the iterate.

Port of ``schwarz_tpu/parallel/exchange.py``: the ``all_gather`` strategy
with every subdomain on one device, and the ``x_ext`` assembly that the
neighbour strategies (``parallel/neighbor_exchange.py``) end in.
For ``all_gather`` the mesh collective over the interior blocks becomes the
``(S, R_int)`` interior array itself, viewed flat.  Each subdomain's
``x_ext`` is zeros, then its interior window, then its halo (the JAX
package's write order, so window-covered halo slots get their true values).
The halo is read from the flat interior array (``all_gather``) or from the
neighbour strategies' compact ``(S, H)`` values.  Either way K2's module
(``ops/halo_kernel.py``) paints that order once per plan into a table of
segments (``build_segments``), and kernel K2 (``assemble_x_ext``) writes the
whole ``x_ext`` from it in one launch.

Neighbouring halo slots with neighbouring sources merge into one segment,
so a contiguous partition's halo is a handful of segments without the JAX
package's run plan (``RunPlan``, a TPU layout for its per-run copies).

Across processes (a :class:`~schwarz_tpu_torch.parallel.mesh.Mesh` of
several) a process holds only its block of subdomains: ``all_gather`` is
then the mesh's, and the halo segments read the gathered ``(S, R_int)``
interiors while the window reads the process's own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext, build_segments


def segments_of(dec, compact: bool = False,
                rows: slice = slice(None)) -> Tuple[np.ndarray, np.ndarray]:
    """K2's tables for a decomposition's subdomains ``rows`` (all by
    default): the halo read from the gathered interiors of all S subdomains
    (the ``all_gather`` strategy), or, with ``compact``, from the neighbour
    strategies' compact halo values of these rows, entry (s, h) at ``s * H
    + h`` with s counted from the first row."""
    meta = dec.meta
    slots = dec.halo_slots[rows]
    Sr, H = slots.shape
    if compact:
        src, n_src = np.arange(Sr * H).reshape(Sr, H), Sr * H
    else:
        src = dec.halo_src_halo[rows]
        n_src = dec.halo_slots.shape[0] * meta.max_interior
    return build_segments(dec.interior_offset[rows], meta.max_interior,
                          meta.max_ext, slots, src, n_src)


def exchange_halo_allgather(
    x_own: torch.Tensor,        # (S, R_int) every subdomain's interior
    segments,                   # (segs, first): segments_of(dec)
    r_ext: int,
    halo_dtype: Optional[torch.dtype] = None,
    mesh=None,                  # a Mesh of several processes, or None
) -> torch.Tensor:
    """x_ext (S, r_ext) in the compute dtype: one K2 launch.  With all
    subdomains on one device the all_gather is the interior array itself,
    so the halo segments read ``x_own`` flat; across processes they read
    ``mesh.all_gather(x_own)``.

    With a ``halo_dtype`` the halo values are rounded to it and back (the
    values of a halo that travelled in ``halo_dtype``); the subdomain's own
    interior window never passes through the reduced precision
    (restricted_schwarz.cpp:898-908)."""
    src = x_own if mesh is None else mesh.all_gather(x_own)
    return assemble_x_ext(x_own, src, *segments, r_ext, halo_dtype)
