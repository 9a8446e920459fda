"""Global convergence detection: port of ``schwarz_tpu/parallel/convergence.py``
for the ``allgather`` (solve.cpp:888-912, trust-local detection) and
``allreduce`` (solve.cpp:949-953) protocols.  With every subdomain on one
device the mesh collectives are plain reductions over the subdomain axis.
The ``tree`` and ``decentralized`` protocols wait for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from schwarz_tpu_torch.config import GlobalConvergence, Settings
from schwarz_tpu_torch.exceptions import NotImplementedFeature


class ConvState(NamedTuple):
    """Protocol state of the ported protocols (the JAX state's tree and
    gossip fields come with those protocols)."""

    detected: torch.Tensor         # (S,) bool: this subdomain knows of global conv
    global_resnorm0: torch.Tensor  # () first global residual norm (allgather)
    ever_local: torch.Tensor       # (S,) bool: monotone local-convergence latch
    res_table: torch.Tensor        # (S, S) min-so-far residual norms (C17 history)


def init_conv_state(S: int, dtype, device) -> ConvState:
    return ConvState(
        detected=torch.zeros(S, dtype=torch.bool, device=device),
        global_resnorm0=torch.tensor(-1.0, dtype=dtype, device=device),
        ever_local=torch.zeros(S, dtype=torch.bool, device=device),
        res_table=torch.full((S, S), torch.finfo(dtype).max, dtype=dtype,
                             device=device),
    )


def conv_step(
    settings: Settings,
    S: int,
    state: ConvState,
    local_resnorm: torch.Tensor,      # (S,)
    local_resnorm0: torch.Tensor,     # (S,)
    locally_converged: torch.Tensor,  # (S,) bool
    adj_in: torch.Tensor,             # (S, S) bool: q sends halo data to p
):
    """One protocol round.  Returns (new_state, num_converged, global_resnorm);
    ``num_converged`` is S exactly when every subdomain may stop."""
    del local_resnorm0
    method = settings.convergence.method
    tol = settings.tolerance
    ever = state.ever_local | locally_converged
    grn_cur = torch.sum(local_resnorm)
    # residual-norm table (conv_tools.hpp:55-142): each subdomain refreshes its
    # own min-so-far entry, then shares it with everyone (put_all) or with its
    # halo-graph neighbours (propagate)
    ids = torch.arange(S, device=local_resnorm.device)
    table_own = state.res_table.clone()
    table_own[ids, ids] = torch.minimum(table_own[ids, ids], local_resnorm)
    if settings.convergence.put_all_local_residual_norms:
        res_table = torch.minimum(table_own, table_own[ids, ids][None, :])
    else:
        big = torch.finfo(table_own.dtype).max
        from_neighbors = torch.where(
            adj_in[:, :, None], table_own[None, :, :],
            torch.full_like(table_own[None], big)).amin(dim=1)
        res_table = torch.minimum(table_own, from_neighbors)

    if method == GlobalConvergence.allgather:
        g0 = torch.where(state.global_resnorm0 < 0, grn_cur,
                         state.global_resnorm0)
        # g0 == 0: the first residual already vanished — converged
        ratio = torch.where(g0 > 0, grn_cur / g0, torch.zeros_like(g0))
        conv = ratio <= tol
        num_conv = torch.where(conv, S, 0).to(torch.int32)
        new = state._replace(
            detected=conv.expand(S).clone(), global_resnorm0=g0,
            ever_local=ever, res_table=res_table,
        )
        return new, num_conv, grn_cur
    if method == GlobalConvergence.allreduce:
        num_conv = torch.sum(locally_converged.to(torch.int32)).to(
            torch.int32)
        new = state._replace(
            detected=(num_conv >= S).expand(S).clone(), ever_local=ever,
            res_table=res_table,
        )
        return new, num_conv, grn_cur
    raise NotImplementedFeature(
        f"convergence method {method.value!r} is not ported yet; the port "
        "supports 'allgather' and 'allreduce'"
    )
