"""Overlap decomposition: the port's copy of ``schwarz_tpu/core/decompose.py``
(numpy, with the native fast path of :mod:`schwarz_tpu_torch.native` where
the library builds; both give the same arrays bit for bit).

Reference semantics, reproduced exactly:
  - subdomain row permutation + first_row offsets  (restricted_schwarz.cpp:97-152)
  - overlap BFS closure: ``overlap - 1`` adjacency rings appended in discovery
    order (restricted_schwarz.cpp:155-180)
  - ghost ring: exterior columns referenced by overlap rows
    (restricted_schwarz.cpp:285-295)
  - nonzero split into the local matrix (interior+overlap rows, closure columns)
    and the interface matrix (overlap rows, exterior columns), the interface
    columns remapped into the extended local index space
    (restricted_schwarz.cpp:194-304)
  - neighbor comm volumes (restricted_schwarz.cpp:307-604) as a table.

Every subdomain is padded to common sizes and all subdomains are stacked on a
leading batch axis; the arrays here are host numpy, bit-identical to the JAX
package's, and move to the device in :mod:`schwarz_tpu_torch.ras`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from schwarz_tpu_torch.config import Metadata, Partition, Settings
from schwarz_tpu_torch.core.partition import (
    _csr_row_gather,
    first_occurrence_unique as _first_occurrence_unique,
    make_partition,
    partition_regular_1d,
)
from schwarz_tpu_torch.exceptions import assert_eq, assert_valid_partition
from schwarz_tpu_torch.models.csr import CSRMatrix


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class Decomposition:
    """Host-side decomposition plan: everything the device solve needs, padded.

    Index spaces per subdomain p (sizes per-subdomain in ``*_count``, padded to the
    common ``meta.max_*``).  The closure (interior + overlap rows) occupies slots
    ``[0, rows_count[p])`` sorted by permuted-global index, with the interior a
    contiguous window ``[interior_offset[p], interior_offset[p] +
    interior_count[p])`` inside it; the ghost ring (exterior columns of overlap
    rows) occupies ``[max_rows, max_rows + ghost_count[p])``.  Ghosts start at
    the *uniform* offset ``max_rows`` so that padded local-matrix rows in
    ``[rows_count[p], max_rows)`` never alias ghost slots (their identity
    diagonals must read zeros).
    """

    meta: Metadata
    settings: Settings
    # permutation between original and subdomain-contiguous (solver) ordering:
    # perm[new] = old, iperm[old] = new (cf. restricted_schwarz.cpp:119-132)
    perm: np.ndarray
    iperm: np.ndarray
    first_row: np.ndarray          # (S+1,) interior row offsets in permuted order
    interior_count: np.ndarray     # (S,)
    interior_offset: np.ndarray    # (S,) closure slot of the first interior row
    rows_count: np.ndarray         # (S,)  == reference local_size_x
    ghost_count: np.ndarray        # (S,) ghost-ring sizes
    local_to_global: np.ndarray    # (S, R_ext) permuted-global index per slot
    # padded batched ELL local matrix (rows interior+overlap, cols in [0, R_rows))
    lmat_cols: np.ndarray          # (S, R_rows, Wl) int32
    lmat_vals: np.ndarray          # (S, R_rows, Wl)
    # padded batched ELL interface matrix (rows = overlap rows, cols in ext space)
    imat_cols: np.ndarray          # (S, R_rows, Wi) int32
    imat_vals: np.ndarray          # (S, R_rows, Wi)
    # row-compacted interface (device hot path: only overlap rows carry
    # interface entries, so the per-iteration gather is O(interface))
    iface_rows: np.ndarray         # (S, Oi) int32; R_rows = scratch pad
    iface_cols: np.ndarray         # (S, Oi, Wi) int32
    iface_vals: np.ndarray         # (S, Oi, Wi)
    local_rhs: np.ndarray          # (S, R_rows) rhs restricted to subdomain rows
    # halo plan: flat index into the all-gathered interior block (S*R_int,)
    halo_src: np.ndarray           # (S, R_ext) int32
    # compact halo tables: only the non-interior valid slots, so the exchange
    # touches O(halo) elements, not O(R_ext)
    halo_slots: np.ndarray         # (S, H) int32 ext-slot index; R_ext = pad
    halo_src_halo: np.ndarray      # (S, H) int32 flat source index
    comm_matrix: np.ndarray        # (S, S) int64: elements p receives from q
    # the permuted global matrix + rhs, for the final true-residual oracle
    global_matrix: CSRMatrix
    global_rhs: np.ndarray         # (N,) permuted ordering

    @property
    def num_subdomains(self) -> int:
        return self.meta.num_subdomains

    def masks(self):
        """(row_valid, interior_valid, ext_valid) boolean masks, shapes
        (S, R_rows), (S, R_int), (S, R_ext)."""
        r = np.arange(self.meta.max_rows)
        row_valid = r[None, :] < self.rows_count[:, None]
        ri = np.arange(self.meta.max_interior)
        interior_valid = ri[None, :] < self.interior_count[:, None]
        re = np.arange(self.meta.max_ext)
        R_rows = self.meta.max_rows
        ext_valid = (re[None, :] < self.rows_count[:, None]) | (
            (re[None, :] >= R_rows)
            & (re[None, :] < R_rows + self.ghost_count[:, None])
        )
        return row_valid, interior_valid, ext_valid

    def valid_ext_slots(self, p: int) -> np.ndarray:
        """Indices of the valid extended slots of subdomain ``p``."""
        R_rows = self.meta.max_rows
        return np.concatenate(
            [
                np.arange(self.rows_count[p]),
                R_rows + np.arange(self.ghost_count[p]),
            ]
        )


def _permute_matrix(mat: CSRMatrix, perm: np.ndarray, iperm: np.ndarray) -> CSRMatrix:
    """A_perm[r, c] = A[perm[r], perm[c]] with columns re-sorted
    (cf. restricted_schwarz.cpp:135-151 + sort_by_column_index).  Uses the
    native kernel when built (schwarz_tpu_torch/native.py), numpy otherwise."""
    from schwarz_tpu_torch import native

    if native.available() and mat.values.dtype == np.float64:
        ip, ix, vv = native.permute_csr(
            mat.n,
            np.ascontiguousarray(mat.row_ptrs, np.int64),
            np.ascontiguousarray(mat.col_idxs, np.int64),
            np.ascontiguousarray(mat.values, np.float64),
            np.ascontiguousarray(perm, np.int64),
            np.ascontiguousarray(iperm, np.int64),
        )
        return CSRMatrix(row_ptrs=ip, col_idxs=ix, values=vv, n=mat.n)
    counts = mat.row_ptrs[perm + 1] - mat.row_ptrs[perm]
    gidx = _csr_row_gather(mat.row_ptrs, perm)
    cols = iperm[mat.col_idxs[gidx]]
    vals = mat.values[gidx]
    row_ptrs = np.zeros(mat.n + 1, dtype=np.int64)
    row_ptrs[1:] = np.cumsum(counts)
    # sort columns within rows
    rows = np.repeat(np.arange(mat.n, dtype=np.int64), counts)
    order = np.lexsort((cols, rows))
    return CSRMatrix(row_ptrs=row_ptrs, col_idxs=cols[order], values=vals[order],
                     n=mat.n)


def decompose(
    mat: CSRMatrix,
    rhs: np.ndarray,
    settings: Settings,
    num_subdomains: int,
    partition_indices: Optional[np.ndarray] = None,
    cell_weights: Optional[np.ndarray] = None,
) -> Decomposition:
    """Build the full decomposition plan from a global CSR matrix + rhs.

    ``cell_weights``: per-row work weights for weight-balanced partitioning
    (regular-1D / metis; see :func:`make_partition`)."""
    N = mat.n
    S = num_subdomains
    assert_eq(mat.row_ptrs.shape[0], N + 1, "row_ptrs length")
    custom_blocks = partition_indices is not None or cell_weights is not None
    if partition_indices is None:
        partition_indices = make_partition(mat, S, settings, cell_weights)
    partition_indices = np.asarray(partition_indices, dtype=np.int64)
    assert_valid_partition(partition_indices, S)
    dtype = np.dtype(settings.dtype)

    # --- permutation & first_row (restricted_schwarz.cpp:97-152) -----------------
    # the nb-block fast path only applies to the *default* regular partition;
    # explicit indices or weighted blocks go through the general (stable
    # argsort) path, which handles any contiguous or scattered partition
    if settings.partition == Partition.regular and S > 1 and not custom_blocks:
        # contiguous blocks: identity permutation, nb-sized blocks; when the
        # reference's ceil formula would empty trailing parts, fall back to
        # the balanced split of partition_regular_1d (same fix there)
        nb = -(-N // S)
        if (S - 1) * nb >= N:
            sizes = np.bincount(
                partition_regular_1d(N, S), minlength=S
            ).astype(np.int64)
            first_row = np.zeros(S + 1, dtype=np.int64)
            first_row[1:] = np.cumsum(sizes)
        else:
            first_row = np.minimum(np.arange(S + 1, dtype=np.int64) * nb, N)
        perm = np.arange(N, dtype=np.int64)
        iperm = perm
        mat_p = mat
    else:
        sizes = np.bincount(partition_indices, minlength=S).astype(np.int64)
        first_row = np.zeros(S + 1, dtype=np.int64)
        first_row[1:] = np.cumsum(sizes)
        # stable: rows of part p keep their relative global order
        perm = np.argsort(partition_indices, kind="stable").astype(np.int64)
        iperm = np.empty(N, dtype=np.int64)
        iperm[perm] = np.arange(N, dtype=np.int64)
        # identity permutation (weighted regular-1D blocks, pre-sorted
        # custom indices): skip the O(nnz) gather + per-row lexsort copy
        if S > 1 and not np.array_equal(perm, np.arange(N, dtype=np.int64)):
            mat_p = _permute_matrix(mat, perm, iperm)
        else:
            mat_p = mat
    rhs_p = np.asarray(rhs, dtype=dtype)[perm]

    row_ptrs, col_idxs, values = mat_p.row_ptrs, mat_p.col_idxs, mat_p.values

    # --- per-subdomain BFS closure (restricted_schwarz.cpp:155-180, 285-295) -----
    rings = max(0, settings.overlap - 1)
    closures: list[np.ndarray] = []  # per subdomain: row slot -> permuted-global
    ghosts: list[np.ndarray] = []    # per subdomain: ghost slot -> permuted-global
    interior_count = np.zeros(S, dtype=np.int64)
    rows_count = np.zeros(S, dtype=np.int64)
    ghost_count = np.zeros(S, dtype=np.int64)
    from schwarz_tpu_torch import native

    use_native = native.available()
    if use_native:
        row_ptrs = np.ascontiguousarray(row_ptrs, np.int64)
        col_idxs = np.ascontiguousarray(col_idxs, np.int64)
        visited_buf = np.zeros(N, dtype=np.int8)
    for p in range(S):
        if use_native:
            closure, ghost = native.closure(
                row_ptrs, col_idxs, first_row[p], first_row[p + 1], rings,
                visited_buf, N,
            )
            interior_count[p] = first_row[p + 1] - first_row[p]
        else:
            interior = np.arange(first_row[p], first_row[p + 1],
                                 dtype=np.int64)
            visited = np.zeros(N, dtype=bool)
            visited[interior] = True
            order = [interior]
            frontier = interior
            for _ in range(rings):
                nbr = col_idxs[_csr_row_gather(row_ptrs, frontier)]
                nbr = _first_occurrence_unique(nbr[~visited[nbr]])
                if nbr.size == 0:
                    frontier = nbr
                    break
                visited[nbr] = True
                order.append(nbr)
                frontier = nbr
            closure = np.concatenate(order)
            interior_count[p] = interior.size
            # ghost ring: exterior columns of the overlap rows (last
            # frontier); for rings == 0 there are no overlap rows and no
            # interface matrix
            if frontier.size:
                nbr = col_idxs[_csr_row_gather(row_ptrs, frontier)]
                ghost = _first_occurrence_unique(nbr[~visited[nbr]])
            else:
                ghost = np.empty(0, dtype=np.int64)
        rows_count[p] = closure.size
        ghost_count[p] = ghost.size
        closures.append(closure)
        ghosts.append(ghost)

    # Closure ordering: the reference orders interior-then-overlap
    # (restricted_schwarz.cpp:155-180).  We sort the closure by permuted-global
    # index instead: every partitioner's interior is a contiguous block in the
    # permuted ordering (first_row), so the interior stays one contiguous
    # window at ``interior_offset``, and the local matrix inherits whatever
    # band structure the permuted global operator has — for regular-1D
    # partitions the exact global bands (zero DIA remainder), for regular-2D
    # grids the block-local bands {+-1, +-width}.  Both orderings represent
    # the same operator; only the internal slot numbering differs.
    interior_offset = np.zeros(S, dtype=np.int64)
    for p in range(S):
        closures[p] = np.sort(closures[p])
        ghosts[p] = np.sort(ghosts[p])
        interior_offset[p] = np.searchsorted(closures[p], first_row[p])
        # interior rows are contiguous in permuted-global numbering, hence
        # contiguous in the sorted closure
        assert closures[p][interior_offset[p]] == first_row[p]

    # --- padded sizes shared by all subdomains ----------------------------------
    pad = settings.row_pad_multiple
    R_int = _round_up(int((first_row[1:] - first_row[:-1]).max()), pad)
    R_rows = _round_up(int(rows_count.max()), pad)
    R_ext = R_rows + _round_up(max(int(ghost_count.max()), 1), pad)

    # --- split nonzeros into local/interface ELL (restricted_schwarz.cpp:194-304)
    # global_to_local per subdomain is materialized ring-by-ring above; here we
    # need, per subdomain, the map permuted-global -> ext slot.
    Wl_max = 0
    Wi_max = 0
    per_sub = []
    g2l_list = []
    values_f64 = (
        np.ascontiguousarray(values, np.float64) if use_native else values
    )
    for p in range(S):
        g2l = np.full(N, -1, dtype=np.int64)
        g2l[closures[p]] = np.arange(rows_count[p], dtype=np.int64)
        g2l[ghosts[p]] = R_rows + np.arange(ghost_count[p], dtype=np.int64)
        rows_p = closures[p]
        if use_native:
            g2l_list.append(g2l)
            wl, wi = native.row_widths(
                row_ptrs, col_idxs, g2l, rows_p, rows_count[p]
            )
            Wl_max, Wi_max = max(Wl_max, wl), max(Wi_max, wi)
            per_sub.append(None)
            continue
        gidx = _csr_row_gather(row_ptrs, rows_p)
        counts = row_ptrs[rows_p + 1] - row_ptrs[rows_p]
        seg = np.repeat(np.arange(rows_p.size, dtype=np.int64), counts)
        cols_l = g2l[col_idxs[gidx]]
        vals_l = values[gidx]
        is_local = cols_l < rows_count[p]
        # interface entries only exist on overlap rows (interior rows are closed
        # for overlap >= 2; for overlap <= 1 the reference drops them — we keep
        # them in the interface matrix, which is strictly more correct)
        l_rows, l_cols, l_vals = seg[is_local], cols_l[is_local], vals_l[is_local]
        i_rows, i_cols, i_vals = seg[~is_local], cols_l[~is_local], vals_l[~is_local]
        wl = int(np.bincount(l_rows, minlength=rows_p.size).max()) if l_rows.size else 1
        wi = int(np.bincount(i_rows, minlength=rows_p.size).max()) if i_rows.size else 0
        Wl_max, Wi_max = max(Wl_max, wl), max(Wi_max, wi)
        per_sub.append((l_rows, l_cols, l_vals, i_rows, i_cols, i_vals))

    Wl = max(Wl_max, 1)
    Wi = max(Wi_max, 1)

    lmat_cols = np.tile(
        np.arange(R_rows, dtype=np.int32)[None, :, None], (S, 1, Wl)
    )  # padding: self-column with value 0 (and diag 1 on padded rows below)
    lmat_vals = np.zeros((S, R_rows, Wl), dtype=dtype)
    imat_cols = np.zeros((S, R_rows, Wi), dtype=np.int32)
    imat_vals = np.zeros((S, R_rows, Wi), dtype=dtype)
    local_to_global = np.zeros((S, R_ext), dtype=np.int64)
    local_rhs = np.zeros((S, R_rows), dtype=dtype)

    for p in range(S):
        if use_native:
            lc = np.ascontiguousarray(lmat_cols[p])
            lv = np.zeros((R_rows, Wl), dtype=np.float64)
            ic = np.zeros((R_rows, Wi), dtype=np.int32)
            iv = np.zeros((R_rows, Wi), dtype=np.float64)
            native.ell_fill(
                row_ptrs, col_idxs, values_f64, g2l_list[p], closures[p],
                rows_count[p], lc, lv, ic, iv,
            )
            lmat_cols[p] = lc
            lmat_vals[p] = lv
            imat_cols[p] = ic
            imat_vals[p] = iv
            prange = np.arange(rows_count[p], R_rows)
            lmat_vals[p, prange, 0] = 1.0
            lmat_cols[p, prange, 0] = prange.astype(np.int32)
            local_to_global[p, : rows_count[p]] = closures[p]
            local_to_global[p, R_rows: R_rows + ghost_count[p]] = ghosts[p]
            local_rhs[p, : rows_count[p]] = rhs_p[closures[p]]
            continue
        l_rows, l_cols, l_vals, i_rows, i_cols, i_vals = per_sub[p]
        # ELL slot position = running index within each row (entries arrive in
        # column-sorted CSR order, so slots stay column-sorted)
        if l_rows.size:
            slot = np.arange(l_rows.size) - np.concatenate(
                ([0], np.cumsum(np.bincount(l_rows, minlength=rows_count[p])))
            )[l_rows]
            lmat_cols[p, l_rows, slot] = l_cols.astype(np.int32)
            lmat_vals[p, l_rows, slot] = l_vals
        if i_rows.size:
            slot = np.arange(i_rows.size) - np.concatenate(
                ([0], np.cumsum(np.bincount(i_rows, minlength=rows_count[p])))
            )[i_rows]
            imat_cols[p, i_rows, slot] = i_cols.astype(np.int32)
            imat_vals[p, i_rows, slot] = i_vals
        # identity diagonal on padded rows keeps direct factorizations nonsingular
        prange = np.arange(rows_count[p], R_rows)
        lmat_vals[p, prange, 0] = 1.0
        lmat_cols[p, prange, 0] = prange.astype(np.int32)
        local_to_global[p, : rows_count[p]] = closures[p]
        local_to_global[p, R_rows: R_rows + ghost_count[p]] = ghosts[p]
        # local rhs: interior contiguous + overlap gather (solver_tools.hpp:101-116)
        local_rhs[p, : rows_count[p]] = rhs_p[closures[p]]

    # --- halo plan (C7, restricted_schwarz.cpp:307-604) --------------------------
    owner = np.searchsorted(first_row, local_to_global, side="right") - 1
    offset = local_to_global - first_row[owner]
    halo_src = (owner * R_int + offset).astype(np.int32)
    # comm volumes: elements p receives from q = valid ext slots of p owned by q,
    # excluding p's own interior (cf. comm_struct recv counts,
    # restricted_schwarz.cpp:333-388)
    comm_matrix = np.zeros((S, S), dtype=np.int64)
    valid_slots = [
        np.concatenate(
            [np.arange(rows_count[p]), R_rows + np.arange(ghost_count[p])]
        )
        for p in range(S)
    ]
    for p in range(S):
        own = owner[p, valid_slots[p]]
        cnt = np.bincount(own[own != p], minlength=S)
        comm_matrix[p, :] = cnt

    # row-compacted interface matrix
    i_nz = imat_vals != 0.0
    i_rows_any = i_nz.any(axis=2)                     # (S, R_rows)
    Oi = max(int(i_rows_any.sum(axis=1).max()), 1)
    iface_rows = np.full((S, Oi), R_rows, dtype=np.int32)
    iface_cols = np.zeros((S, Oi, Wi), dtype=np.int32)
    iface_vals = np.zeros((S, Oi, Wi), dtype=imat_vals.dtype)
    for p in range(S):
        rws = np.nonzero(i_rows_any[p])[0]
        iface_rows[p, : rws.size] = rws.astype(np.int32)
        iface_cols[p, : rws.size] = imat_cols[p, rws]
        iface_vals[p, : rws.size] = imat_vals[p, rws]

    # compact halo tables: slots beyond the interior (overlap + ghost); padded
    # entries point at the scratch slot R_ext (the exchange allocates R_ext+1)
    halo_counts = (rows_count - interior_count) + ghost_count
    H = _round_up(max(int(halo_counts.max()), 1), pad)
    halo_slots = np.full((S, H), R_ext, dtype=np.int32)
    halo_src_halo = np.zeros((S, H), dtype=np.int32)
    for p in range(S):
        row_slots = np.arange(rows_count[p], dtype=np.int64)
        in_interior = (row_slots >= interior_offset[p]) & (
            row_slots < interior_offset[p] + interior_count[p]
        )
        slots = np.concatenate([
            row_slots[~in_interior],
            R_rows + np.arange(ghost_count[p], dtype=np.int64),
        ])
        halo_slots[p, : slots.size] = slots.astype(np.int32)
        halo_src_halo[p, : slots.size] = halo_src[p, slots]

    meta = Metadata(
        global_size=N,
        num_subdomains=S,
        overlap=settings.overlap,
        max_interior=R_int,
        max_rows=R_rows,
        max_ext=R_ext,
        ell_width_local=Wl,
        ell_width_interface=Wi,
        nnz_global=mat.nnz,
    )
    return Decomposition(
        meta=meta,
        settings=settings,
        perm=perm,
        iperm=iperm,
        first_row=first_row,
        interior_count=interior_count,
        interior_offset=interior_offset,
        rows_count=rows_count,
        ghost_count=ghost_count,
        local_to_global=local_to_global,
        lmat_cols=lmat_cols,
        lmat_vals=lmat_vals,
        imat_cols=imat_cols,
        imat_vals=imat_vals,
        iface_rows=iface_rows,
        iface_cols=iface_cols,
        iface_vals=iface_vals,
        local_rhs=local_rhs,
        halo_src=halo_src,
        halo_slots=halo_slots,
        halo_src_halo=halo_src_halo,
        comm_matrix=comm_matrix,
        global_matrix=mat_p,
        global_rhs=rhs_p,
    )
