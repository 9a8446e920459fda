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
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext, build_segments


def segments_of(dec, compact: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """K2's tables for a decomposition: the halo read from the gathered
    interiors (the ``all_gather`` strategy), or, with ``compact``, from the
    neighbour strategies' compact halo values, entry (s, h) at ``s * H +
    h``."""
    meta = dec.meta
    S, H = dec.halo_slots.shape
    if compact:
        src, n_src = np.arange(S * H).reshape(S, H), S * H
    else:
        src, n_src = dec.halo_src_halo, S * meta.max_interior
    return build_segments(dec.interior_offset, meta.max_interior,
                          meta.max_ext, dec.halo_slots, src, n_src)


def exchange_halo_allgather(
    x_own: torch.Tensor,        # (S, R_int) every subdomain's interior
    segments,                   # (segs, first): segments_of(dec)
    r_ext: int,
    halo_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x_ext (S, r_ext) in the compute dtype: one K2 launch.  With all
    subdomains on one device the all_gather is the interior array itself,
    so the halo segments read ``x_own`` flat.

    With a ``halo_dtype`` the halo values are rounded to it and back (the
    values of a halo that travelled in ``halo_dtype``); the subdomain's own
    interior window never passes through the reduced precision
    (restricted_schwarz.cpp:898-908)."""
    return assemble_x_ext(x_own, x_own, *segments, r_ext, halo_dtype)
