"""Partitioners: the port's copy of ``schwarz_tpu/core/partition.py``: the
regular 1-D and 2-D partitions (reference restricted_schwarz.cpp:84,98-102,
partition_tools.hpp:69-106) and the METIS-equivalent multilevel recursive
bisection (heavy-edge-matching coarsening, multi-start GGGP/BFS initial
splits of the coarsest graph, Fiduccia-Mattheyses refinement at every
uncoarsening level).  Deterministic numpy and ``heapq`` loops: the same calls
in the same order as the JAX package, so the partitions are bit-identical.
"""

from __future__ import annotations

import heapq

import numpy as np

from schwarz_tpu_torch.exceptions import PartitionError
from schwarz_tpu_torch.models.csr import CSRMatrix


def first_occurrence_unique(a: np.ndarray) -> np.ndarray:
    """Unique values of ``a`` in first-occurrence order (the reference's
    scan-order marking of global_to_local, restricted_schwarz.cpp:167-180)."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def _csr_row_gather(row_ptrs: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Indices into col_idxs covering all entries of ``rows``, row-major order."""
    starts = row_ptrs[rows]
    counts = row_ptrs[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    offsets = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return offsets + np.arange(total, dtype=np.int64)


def partition_regular_1d(
    n: int, nparts: int, cell_weights=None,
) -> np.ndarray:
    """Contiguous equal blocks of ``ceil(n/nparts)`` rows
    (restricted_schwarz.cpp:84,98-102: ``nb = (n + S - 1) / S``).

    When that formula would leave trailing parts empty the split is balanced
    instead (sizes differ by at most one).  With ``cell_weights`` the block
    boundaries equalize cumulative weight; parts stay contiguous and
    non-empty.
    """
    if cell_weights is None:
        nb = -(-n // nparts)
        if (nparts - 1) * nb >= n:
            if n < nparts:
                raise PartitionError(
                    f"cannot split {n} rows into {nparts} non-empty parts"
                )
            base, extra = divmod(n, nparts)
            sizes = np.full(nparts, base, dtype=np.int64)
            sizes[:extra] += 1
            return np.repeat(
                np.arange(nparts, dtype=np.int32), sizes
            )
        return np.minimum(
            np.arange(n, dtype=np.int64) // nb, nparts - 1
        ).astype(np.int32)
    w = np.asarray(cell_weights, dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"cell_weights has shape {w.shape}, expected ({n},)")
    cw = np.cumsum(w)
    total = cw[-1] if cw[-1] > 0 else 1.0
    bounds = np.searchsorted(
        cw, total * np.arange(1, nparts) / nparts, side="left"
    ).astype(np.int64)
    # enforce non-empty contiguous parts
    for k in range(bounds.size):
        lo = (bounds[k - 1] if k else 0) + 1
        bounds[k] = min(max(bounds[k], lo), n - (bounds.size - k))
    part = np.zeros(n, dtype=np.int32)
    part[bounds] += 1
    return np.cumsum(part).astype(np.int32)


def partition_regular_2d(n: int, nparts: int) -> np.ndarray:
    """Square grid blocks for an ``sqrt(n) x sqrt(n)`` domain
    (partition_tools.hpp:69-106).  Requires ``n`` and ``nparts`` to be perfect
    squares with ``sqrt(nparts) | sqrt(n)``."""
    sq_n = int(round(np.sqrt(n)))
    sq_p = int(round(np.sqrt(nparts)))
    if sq_n * sq_n != n:
        raise ValueError(f"regular2d needs a square grid, got n={n}")
    if sq_p * sq_p != nparts or sq_n % sq_p != 0:
        raise ValueError(
            f"regular2d needs square nparts dividing the grid, got {nparts} for {sq_n}^2"
        )
    b = sq_n // sq_p
    i = np.arange(n, dtype=np.int64)
    x, y = i % sq_n, i // sq_n
    return (sq_p * (y // b) + (x // b)).astype(np.int32)


def _pseudo_peripheral(row_ptrs, col_idxs, vertices, vset_mask) -> int:
    """Approximate a peripheral vertex of the subgraph by two BFS sweeps."""
    start = int(vertices[0])
    for _ in range(2):
        dist = np.full(vset_mask.shape[0], -1, dtype=np.int64)
        dist[start] = 0
        frontier = np.array([start], dtype=np.int64)
        d = 0
        while frontier.size:
            nbr = col_idxs[_csr_row_gather(row_ptrs, frontier)]
            nbr = nbr[vset_mask[nbr] & (dist[nbr] < 0)]
            if nbr.size == 0:
                break
            nbr = np.unique(nbr)
            d += 1
            dist[nbr] = d
            frontier = nbr
        far = vertices[dist[vertices] == dist[vertices].max()]
        start = int(far[0])
    return start


def _grow_bisection(row_ptrs, col_idxs, vertices, target: int) -> np.ndarray:
    """Greedy BFS-growth bisection: grow part 0 from a peripheral vertex until it
    holds ``target`` vertices; returns a bool mask over ``vertices`` (True = part 0).
    Level-structure growth is METIS's GGP initial-partition strategy."""
    n_all = row_ptrs.shape[0] - 1
    vset_mask = np.zeros(n_all, dtype=bool)
    vset_mask[vertices] = True
    seed = _pseudo_peripheral(row_ptrs, col_idxs, vertices, vset_mask)

    in0 = np.zeros(n_all, dtype=bool)
    in0[seed] = True
    size = 1
    frontier = np.array([seed], dtype=np.int64)
    while size < target and frontier.size:
        nbr = col_idxs[_csr_row_gather(row_ptrs, frontier)]
        nbr = nbr[vset_mask[nbr] & ~in0[nbr]]
        if nbr.size == 0:
            break
        # first-occurrence order keeps growth contiguous and deterministic
        nbr = first_occurrence_unique(nbr)
        take = min(target - size, nbr.size)
        chosen = nbr[:take]
        in0[chosen] = True
        size += take
        frontier = chosen
    if size < target:
        # disconnected subgraph: top up with arbitrary remaining vertices
        rest = vertices[~in0[vertices]]
        in0[rest[: target - size]] = True
    return in0[vertices]


def _refine_boundary(row_ptrs, col_idxs, vertices, mask0, rounds: int = 8):
    """Greedy KL/FM-style refinement: move boundary vertices with positive gain
    (cut-edge reduction) between the halves, keeping balance within 2%."""
    n_all = row_ptrs.shape[0] - 1
    side = np.full(n_all, -1, dtype=np.int8)
    side[vertices] = 1
    side[vertices[mask0]] = 0
    target0 = int(mask0.sum())
    # lo >= 1: a tiny part (target0 == 1) must never be emptied — an empty
    # part crashes decompose downstream
    lo, hi = max(1, int(target0 * 0.98)), int(np.ceil(target0 * 1.02))
    size0 = target0
    for _ in range(rounds):
        gidx = _csr_row_gather(row_ptrs, vertices)
        cols = col_idxs[gidx]
        counts = row_ptrs[vertices + 1] - row_ptrs[vertices]
        seg = np.repeat(np.arange(vertices.size), counts)
        same = (side[cols] == side[vertices][seg]) & (side[cols] >= 0)
        other = (side[cols] == 1 - side[vertices][seg]) & (side[cols] >= 0)
        gain = np.zeros(vertices.size, dtype=np.int64)
        np.add.at(gain, seg[other], 1)
        np.add.at(gain, seg[same], -1)
        movable = gain > 0
        if not movable.any():
            break
        # move best-gain vertices one side at a time to preserve balance
        order = np.argsort(-gain)
        moved = 0
        for vi in order:
            if not movable[vi]:
                continue
            v = vertices[vi]
            if side[v] == 0 and size0 - 1 >= lo:
                side[v] = 1
                size0 -= 1
                moved += 1
            elif side[v] == 1 and size0 + 1 <= hi:
                side[v] = 0
                size0 += 1
                moved += 1
            if moved >= max(1, vertices.size // 50):
                break
        if moved == 0:
            break
    return side[vertices] == 0


def _heavy_edge_matching(row_ptrs, col_idxs, weights):
    """One coarsening level: greedy heavy-edge matching.  Returns (coarse_map,
    n_coarse) where coarse_map[v] is v's coarse vertex id."""
    n = row_ptrs.shape[0] - 1
    matched = np.full(n, -1, dtype=np.int64)
    order = np.argsort(weights)          # match light vertices first (METIS HEM)
    for v in order:
        if matched[v] >= 0:
            continue
        best, best_w = -1, -1
        for j in range(row_ptrs[v], row_ptrs[v + 1]):
            u = col_idxs[j]
            if u != v and matched[u] < 0:
                if weights[u] > best_w:
                    best, best_w = u, weights[u]
        if best >= 0:
            matched[v] = best
            matched[best] = v
        else:
            matched[v] = v
    coarse_map = np.full(n, -1, dtype=np.int64)
    nc = 0
    for v in range(n):
        if coarse_map[v] < 0:
            coarse_map[v] = nc
            coarse_map[matched[v]] = nc
            nc += 1
    return coarse_map, nc


def _coarsen(row_ptrs, col_idxs, coarse_map, nc):
    """Contract the graph along coarse_map (multi-edges merged)."""
    rows = np.repeat(
        np.arange(row_ptrs.shape[0] - 1, dtype=np.int64), np.diff(row_ptrs)
    )
    cr, cc = coarse_map[rows], coarse_map[col_idxs]
    off = cr != cc
    key = cr[off] * nc + cc[off]
    uniq = np.unique(key)
    ur, uc = uniq // nc, uniq % nc
    ptr = np.zeros(nc + 1, dtype=np.int64)
    np.add.at(ptr, ur + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, uc


def _bisect_multilevel(
    row_ptrs, col_idxs, vertices, target: int, vweights=None,
) -> np.ndarray:
    """Multilevel bisection: heavy-edge-matching coarsening, BFS-growth split of
    the coarsest graph, KL-style refinement at every uncoarsening level —
    the METIS recipe (cf. the PartGraphRecursive role, partition_tools.hpp:182).

    ``vweights`` (per entry of ``vertices``): balance on vertex weight instead
    of count; ``target`` is then a weight target."""
    # build the induced subgraph with local ids
    n_all = row_ptrs.shape[0] - 1
    g2l = np.full(n_all, -1, dtype=np.int64)
    g2l[vertices] = np.arange(vertices.size)
    gidx = _csr_row_gather(row_ptrs, vertices)
    cols = g2l[col_idxs[gidx]]
    counts = np.diff(row_ptrs)[vertices]
    rows = np.repeat(np.arange(vertices.size, dtype=np.int64), counts)
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep]
    ptr = np.zeros(vertices.size + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    np.cumsum(ptr, out=ptr)

    levels = []
    cur_ptr, cur_cols = ptr, cols
    fine_w = (
        np.ones(vertices.size, dtype=np.int64)
        if vweights is None
        else np.asarray(vweights, dtype=np.int64)
    )
    weights = fine_w
    w_levels = [fine_w]
    graphs = [(ptr, cols)]          # per-level graphs, reused at uncoarsening
    while cur_ptr.shape[0] - 1 > 200:
        cmap, nc = _heavy_edge_matching(cur_ptr, cur_cols, weights)
        if nc >= cur_ptr.shape[0] - 1:   # no contraction possible
            break
        levels.append(cmap)
        cur_ptr, cur_cols = _coarsen(cur_ptr, cur_cols, cmap, nc)
        graphs.append((cur_ptr, cur_cols))
        w_new = np.zeros(nc, dtype=np.int64)
        np.add.at(w_new, cmap, weights)
        weights = w_new
        w_levels.append(weights)

    # initial split of the coarsest graph: weighted BFS growth from several
    # seeds, keep the best cut after refinement (METIS also generates
    # multiple initial partitions and picks the best)
    nc = cur_ptr.shape[0] - 1
    vs = np.arange(nc, dtype=np.int64)
    denom = vertices.size if vweights is None else max(int(fine_w.sum()), 1)
    frac = target / max(denom, 1)
    vset_all = np.ones(nc, dtype=bool)
    seeds = {_pseudo_peripheral(cur_ptr, cur_cols, vs, vset_all)}
    rng = np.random.default_rng(nc)
    while len(seeds) < min(4, nc):
        seeds.add(int(rng.integers(nc)))
    crows = np.repeat(np.arange(nc, dtype=np.int64), np.diff(cur_ptr))
    best_cut, side = None, None
    target_w = int(round(int(weights.sum()) * frac))
    for seed in sorted(seeds):
        for grow in ("gggp", "bfs"):
            if grow == "gggp":
                m0 = _grow_gggp(cur_ptr, cur_cols, weights, seed, target_w)
            else:
                m0 = _grow_bisection_weighted(
                    cur_ptr, cur_cols, vs, weights, frac, seed=seed)
            m0 = _refine_side(cur_ptr, cur_cols, m0, target_frac=frac,
                              weights=weights)
            cut = int((m0[crows] != m0[cur_cols]).sum())
            if best_cut is None or cut < best_cut:
                best_cut, side = cut, m0

    # uncoarsen + refine (the per-level graphs were kept from coarsening —
    # rebuilding them here would double the contraction cost)
    # balance refinement on counts (reference behavior) or weights
    wl = (lambda i: None) if vweights is None else (lambda i: w_levels[i])
    for idx in reversed(range(len(levels))):
        side = side[levels[idx]]
        lptr, lcols = graphs[idx]
        side = _refine_side(lptr, lcols, side, target_frac=frac,
                            weights=wl(idx))
    if not levels:
        side = _refine_side(ptr, cols, side, target_frac=frac,
                            weights=wl(0))
    return side


def _grow_gggp(ptr, cols, weights, seed: int, target_w: int) -> np.ndarray:
    """Greedy Graph Growing (GGGP, METIS's initial-partition strategy): grow
    part 0 from ``seed`` by repeatedly absorbing the frontier vertex whose
    addition shrinks the cut most.  Unlike plain BFS order this grows FLAT
    fronts on mesh graphs (a BFS diamond costs ~2x the straight-cut length,
    and move-based refinement cannot rotate a diagonal boundary)."""
    n = ptr.shape[0] - 1
    in0 = np.zeros(n, dtype=bool)
    in0[seed] = True
    wsum = int(weights[seed])
    # gain of adding v = (edges into part 0) - (edges outside): higher first
    gain = np.zeros(n, dtype=np.int64)
    heap = []
    for u in cols[ptr[seed]:ptr[seed + 1]]:
        gain[u] += 2                       # one edge flipped ext -> int
        heapq.heappush(heap, (-int(gain[u]), int(u)))
    while wsum < target_w and heap:
        negg, v = heapq.heappop(heap)
        if in0[v] or -negg != gain[v]:
            continue
        in0[v] = True
        wsum += int(weights[v])
        for u in cols[ptr[v]:ptr[v + 1]]:
            if not in0[u]:
                gain[u] += 2
                heapq.heappush(heap, (-int(gain[u]), int(u)))
    if wsum < target_w:                    # disconnected: top up
        for v in np.nonzero(~in0)[0]:
            if wsum >= target_w:
                break
            in0[v] = True
            wsum += int(weights[v])
    return in0


def _grow_bisection_weighted(row_ptrs, col_idxs, vertices, weights, frac,
                             seed=None):
    """BFS growth on a weighted (coarse) graph until ~frac of total weight."""
    total = int(weights.sum())
    target_w = int(round(total * frac))
    n = vertices.size
    if n == 0:
        return np.zeros(0, dtype=bool)
    if seed is None:
        vset = np.ones(row_ptrs.shape[0] - 1, dtype=bool)
        seed = _pseudo_peripheral(row_ptrs, col_idxs, vertices, vset)
    in0 = np.zeros(n, dtype=bool)
    in0[seed] = True
    wsum = int(weights[seed])
    frontier = np.array([seed], dtype=np.int64)
    while wsum < target_w and frontier.size:
        nbr = col_idxs[_csr_row_gather(row_ptrs, frontier)]
        nbr = nbr[~in0[nbr]]
        if nbr.size == 0:
            break
        nbr = first_occurrence_unique(nbr)
        chosen = []
        for u in nbr:
            if wsum >= target_w:
                break
            in0[u] = True
            wsum += int(weights[u])
            chosen.append(u)
        frontier = np.array(chosen, dtype=np.int64)
    if wsum < target_w:
        rest = np.nonzero(~in0)[0]
        for u in rest:
            if wsum >= target_w:
                break
            in0[u] = True
            wsum += int(weights[u])
    return in0


def _refine_side(ptr, cols, side, target_frac, rounds: int = 24,
                 weights=None, balance_tol: float = 0.02):
    """KL/FM-style gain refinement on a local-id graph with a bool side array.

    ``weights``: balance on vertex weight (weighted partitioning) instead of
    vertex count; the unweighted path is bit-identical to weights of ones.
    ``balance_tol``: allowed relative imbalance — wider at coarse levels
    (METIS ufactor role) lets refinement escape diagonal-cut local minima."""
    n = side.shape[0]
    w = None if weights is None else np.asarray(weights, dtype=np.int64)
    total = n if w is None else int(w.sum())
    target0 = int(round(total * target_frac))
    lo = max(1, int(target0 * (1 - balance_tol)))
    hi = int(np.ceil(target0 * (1 + balance_tol)))
    side = side.copy()
    size0 = int(side.sum()) if w is None else int(w[side].sum())
    wt = (lambda v: 1) if w is None else (lambda v: int(w[v]))
    deg = np.diff(ptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    # restore balance first if coarse-level granularity left us outside the
    # window: move best-gain vertices from the heavy side regardless of
    # sign.  Bounded and oscillation-guarded: a single vertex weight wider
    # than the balance window can never land inside it — it would bounce
    # between the sides forever, so break on a revisited size (keeping the
    # closest achievable balance) rather than hang.
    seen_sizes = set()
    best_side, best_dist = None, None

    def _track_best():
        nonlocal best_side, best_dist
        n0 = int(side.sum())
        if 0 < n0 < n:                       # both sides non-empty
            dist = abs(size0 - target0)
            if best_dist is None or dist < best_dist:
                best_side, best_dist = side.copy(), dist

    _track_best()
    for _ in range(64):
        if lo <= size0 <= hi or size0 in seen_sizes:
            break
        seen_sizes.add(size0)
        gain = np.zeros(n, dtype=np.int64)
        np.add.at(gain, rows, np.where(side[rows] == side[cols], -1, 1))
        from_side = size0 > hi
        cand = np.nonzero(side == from_side)[0]
        if cand.size == 0:
            break
        deficit = lo - size0 if size0 < lo else size0 - hi
        ordered = cand[np.argsort(-gain[cand])]
        if w is None:
            movers = ordered[: max(1, deficit)]
        else:
            take = np.searchsorted(np.cumsum(w[ordered]), deficit) + 1
            movers = ordered[: max(1, min(int(take), ordered.size))]
        side[movers] = not from_side
        mw = movers.size if w is None else int(w[movers].sum())
        size0 += (1 if not from_side else -1) * mw
        _track_best()
    # if the loop ended outside the window (oscillation / exhaustion),
    # restore the closest configuration that keeps both sides non-empty —
    # an empty side crashes the decomposition downstream
    n0_cur = int(side.sum())
    if (not lo <= size0 <= hi or n0_cur in (0, n)) and best_side is not None:
        side = best_side
        size0 = int(side.sum()) if w is None else int(w[side].sum())
    # Fiduccia–Mattheyses passes: sequential boundary moves with incremental
    # gain updates, hill-climbing (negative-gain moves allowed) with rollback
    # to the best prefix, each vertex moved at most once per pass.  This is
    # the refinement METIS itself runs per uncoarsening level (the round-1
    # greedy positive-gain-only batch version plateaued at ~1.6x the METIS
    # cut; FM reaches ~1.1-1.3x on grid benchmarks).
    for _ in range(rounds):
        gain = np.zeros(n, dtype=np.int64)
        np.add.at(gain, rows, np.where(side[rows] == side[cols], -1, 1))
        on_boundary = np.zeros(n, dtype=bool)
        np.logical_or.at(on_boundary, rows, side[rows] != side[cols])
        cand = np.nonzero(on_boundary)[0]
        if cand.size == 0:
            break
        heap = [(-int(gain[v]), int(v)) for v in cand]
        heapq.heapify(heap)
        in_heap = np.zeros(n, dtype=bool)
        in_heap[cand] = True
        locked = np.zeros(n, dtype=bool)
        move_cap = min(n, max(256, 8 * cand.size))
        history = []          # (v, wt_delta_applied)
        cum = 0
        best_cum, best_idx = 0, -1
        sz = size0
        while heap and len(history) < move_cap:
            negg, v = heapq.heappop(heap)
            if locked[v] or -negg != gain[v]:
                continue      # stale entry
            wv = wt(v)
            if side[v]:
                if sz - wv < lo:
                    continue
                delta = -wv
            else:
                if sz + wv > hi:
                    continue
                delta = wv
            locked[v] = True
            old = bool(side[v])
            side[v] = not old
            sz += delta
            cum += int(gain[v])
            history.append((v, delta))
            if cum > best_cum:
                best_cum, best_idx = cum, len(history) - 1
            for u in cols[ptr[v]:ptr[v + 1]]:
                if locked[u]:
                    continue
                # v left side `old`: u on `old` gains an external edge (+2),
                # u on the other side loses one (-2)
                gain[u] += 2 if side[u] == old else -2
                heapq.heappush(heap, (-int(gain[u]), int(u)))
                in_heap[u] = True
        # roll back past the best prefix
        for v, delta in history[best_idx + 1:]:
            side[v] = not side[v]
            sz -= delta
        size0 = sz
        if best_cum <= 0:
            break
    return side


def partition_metis(
    mat: CSRMatrix, nparts: int, objtype: str = "edgecut",
    cell_weights=None,
) -> np.ndarray:
    """METIS-equivalent multilevel recursive bisection
    (cf. partition_tools.hpp:109-202).

    Heavy-edge-matching coarsening, BFS-growth initial partition, KL-style
    refinement per uncoarsening level; ``nparts`` need not be a power of two
    (unbalanced recursion like METIS_PartGraphRecursive).  ``objtype`` accepted
    for parity; both objectives reduce to edge-cut minimization here.
    ``cell_weights`` (beyond the reference, which passes a null weight pointer
    to METIS — the real pointer is commented out at partition_tools.hpp:185):
    per-row work weights; when given, every bisection balances cumulative
    weight instead of row count (heterogeneous-cost rows, e.g. locally-refined
    meshes).
    """
    nparts = min(nparts, mat.n)
    w = (
        None if cell_weights is None
        else np.asarray(cell_weights, dtype=np.int64)
    )
    part = np.zeros(mat.n, dtype=np.int32)
    stack = [(np.arange(mat.n, dtype=np.int64), 0, nparts)]
    while stack:
        vertices, base, k = stack.pop()
        if k <= 1:
            part[vertices] = base
            continue
        k0 = k // 2
        if w is None:
            target = int(round(vertices.size * (k0 / k)))
            if vertices.size > 400:
                mask0 = _bisect_multilevel(
                    mat.row_ptrs, mat.col_idxs, vertices, target
                )
            else:
                mask0 = _grow_bisection(
                    mat.row_ptrs, mat.col_idxs, vertices, target
                )
                mask0 = _refine_boundary(
                    mat.row_ptrs, mat.col_idxs, vertices, mask0
                )
        else:
            target = int(round(int(w[vertices].sum()) * (k0 / k)))
            mask0 = _bisect_multilevel(
                mat.row_ptrs, mat.col_idxs, vertices, target,
                vweights=w[vertices],
            )
        stack.append((vertices[mask0], base, k0))
        stack.append((vertices[~mask0], base + k0, k - k0))
    # repair pass: a degenerate bisection (tiny subsets, star graphs, a
    # dominant weight) can leave a part empty — every part must own at
    # least one row or the decomposition crashes downstream.  Steal one
    # vertex from the currently largest part per empty part.
    counts = np.bincount(part, minlength=nparts)
    for p_empty in np.nonzero(counts == 0)[0]:
        donor = int(np.argmax(counts))
        vs = np.nonzero(part == donor)[0]
        part[vs[-1]] = p_empty
        counts[donor] -= 1
        counts[p_empty] += 1
    return part


def make_partition(
    mat: CSRMatrix, nparts: int, settings, cell_weights=None,
) -> np.ndarray:
    """Dispatch on Settings.partition (cf. Initialize::partition,
    source/initialization.cpp:278-329).  ``cell_weights``: per-row work
    weights for weight-balanced partitioning (regular 1-D and metis)."""
    from schwarz_tpu_torch.config import Partition

    if cell_weights is not None:
        cell_weights = np.asarray(cell_weights)
        if cell_weights.shape != (mat.n,):
            raise ValueError(
                f"cell_weights must have shape ({mat.n},) — one weight per "
                f"matrix row — got {cell_weights.shape}"
            )
        if (cell_weights < 0).any():
            raise ValueError("cell_weights must be non-negative")
    if nparts == 1:
        return np.zeros(mat.n, dtype=np.int32)
    if settings.partition == Partition.regular:
        return partition_regular_1d(mat.n, nparts, cell_weights)
    if settings.partition == Partition.regular2d:
        if cell_weights is not None:
            raise ValueError(
                "cell_weights: use partition='regular' or 'metis' "
                "(regular2d blocks are fixed squares)"
            )
        return partition_regular_2d(mat.n, nparts)
    if settings.partition == Partition.metis:
        return partition_metis(
            mat, nparts, settings.metis_objtype, cell_weights
        )
    raise ValueError(f"unsupported partition {settings.partition}")
