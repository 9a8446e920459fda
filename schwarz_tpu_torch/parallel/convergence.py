"""Global convergence detection: port of ``schwarz_tpu/parallel/convergence.py``
(reference components C16-C19, source/solve.cpp:859-955,
include/conv_tools.hpp).  Each protocol is one transition per outer
iteration on a small bool/int state.  With every subdomain on one device the
mesh collectives are plain reductions and gathers over the subdomain axis,
so the result does not depend on the rank count.

Protocols:
  - ``allgather``:     sum of local norms against the global tolerance
                       (solve.cpp:888-912), trust-local detection.
  - ``allreduce``:     count of locally converged subdomains
                       (solve.cpp:949-953).
  - ``tree``:          centralized binary-tree push-up / push-down
                       (conv_tools.hpp:146-209), in the JAX package's
                       corrected form: a node pushes up once, when it is
                       locally converged and its existing children have
                       pushed; the root then broadcasts down the tree, one
                       level per iteration.
  - ``decentralized``: bit-vector gossip along the halo graph with
                       sent-dedup (conv_tools.hpp:212-275), or the
                       MPI_Accumulate-style counter (``enable_accumulate``,
                       conv_tools.hpp:230-247).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from schwarz_tpu_torch.config import GlobalConvergence, Settings


class ConvState(NamedTuple):
    """Protocol state over all S subdomains, with the JAX package's fields
    in its order; a protocol leaves the fields it does not use at zero."""

    detected: torch.Tensor         # (S,) bool: this subdomain knows of global conv
    global_resnorm0: torch.Tensor  # () first global residual norm (allgather)
    up_done: torch.Tensor          # (S,) bool: tree, pushed to parent
    got_left: torch.Tensor         # (S,) bool: tree, left child pushed
    got_right: torch.Tensor        # (S,) bool: tree, right child pushed
    ever_local: torch.Tensor       # (S,) bool: monotone local-convergence latch
    known: torch.Tensor            # (S, S) bool: decentralized gossip bits
    sent: torch.Tensor             # (S, S) bool: decentralized dedup
    counter: torch.Tensor          # (S,) int32: accumulate variant
    counted: torch.Tensor          # (S,) bool: accumulate dedup
    res_table: torch.Tensor        # (S, S) min-so-far residual norms (C17 history)


def init_conv_state(S: int, dtype, device) -> ConvState:
    def flags(*shape):
        return torch.zeros(shape, dtype=torch.bool, device=device)

    return ConvState(
        detected=flags(S),
        global_resnorm0=torch.tensor(-1.0, dtype=dtype, device=device),
        up_done=flags(S), got_left=flags(S), got_right=flags(S),
        ever_local=flags(S),
        known=flags(S, S), sent=flags(S, S),
        counter=torch.zeros(S, dtype=torch.int32, device=device),
        counted=flags(S),
        res_table=torch.full((S, S), torch.finfo(dtype).max, dtype=dtype,
                             device=device),
    )


def _all_or_none(count: torch.Tensor, S: int) -> torch.Tensor:
    """S when ``count`` subdomains (all of them) have detected, else 0."""
    return torch.where(count >= S, S, 0).to(torch.int32)


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
    if method == GlobalConvergence.tree:
        left, right = 2 * ids + 1, 2 * ids + 2
        has_left, has_right = left < S, right < S
        ready_up = (ever & (~has_left | state.got_left)
                    & (~has_right | state.got_right) & ~state.up_done)
        # what a node decides now reaches its parent and children in this
        # round: one tree level per outer iteration
        down_now = state.detected | ((ids == 0) & ready_up)
        got_left = state.got_left | (has_left & ready_up[left % S])
        got_right = state.got_right | (has_right & ready_up[right % S])
        parent = torch.clamp(ids - 1, min=0) // 2
        detected = down_now | down_now[parent]
        new = state._replace(
            detected=detected, up_done=state.up_done | ready_up,
            got_left=got_left, got_right=got_right, ever_local=ever,
            res_table=res_table,
        )
        return new, _all_or_none(torch.sum(detected), S), grn_cur
    if method == GlobalConvergence.decentralized:
        if settings.convergence.enable_accumulate:
            newly = ever & ~state.counted
            counter = state.counter + torch.sum(newly).to(torch.int32)
            new = state._replace(
                counter=counter, counted=state.counted | newly,
                detected=counter >= S, ever_local=ever, res_table=res_table,
            )
            return new, _all_or_none(torch.sum(counter >= S), S), grn_cur
        # gossip: send newly known bits to out-neighbours
        # (conv_tools.hpp:249-274)
        known = state.known.clone()
        known[ids, ids] = known[ids, ids] | ever
        to_send = known & ~state.sent                       # (S, S)
        # counts of at most S: exact in float32
        incoming = (adj_in.to(torch.float32)
                    @ to_send.to(torch.float32)) > 0
        new_known = known | incoming
        count = torch.sum(new_known, dim=1)
        new = state._replace(
            known=new_known, sent=known, detected=count >= S,
            ever_local=ever, res_table=res_table,
        )
        return new, _all_or_none(torch.sum(count >= S), S), grn_cur
    raise ValueError(f"unknown convergence method {method}")
