"""The port's host setup against the JAX package's: partition, overlap
decomposition and DIA split must be bit-identical, and K2's segment table
must hold the halo runs of the JAX package's run plan."""

import dataclasses
import importlib

import numpy as np
import pytest

import schwarz_tpu.config as jcfg
import schwarz_tpu.core.partition as jpart
import schwarz_tpu.models as jmodels
import schwarz_tpu.ops.dia as jdia
import schwarz_tpu.parallel.exchange as jex
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.core.partition as tpart
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.ops.dia as tdia
import schwarz_tpu_torch.ops.halo_kernel as thk
import schwarz_tpu_torch.parallel.exchange as tex

# the modules, not the ``decompose`` functions the packages re-export
jdec = importlib.import_module("schwarz_tpu.core.decompose")
tdec = importlib.import_module("schwarz_tpu_torch.core.decompose")

ARRAYS = ("perm", "iperm", "first_row", "interior_count", "interior_offset",
          "rows_count", "ghost_count", "local_to_global", "lmat_cols",
          "lmat_vals", "imat_cols", "imat_vals", "iface_rows", "iface_cols",
          "iface_vals", "local_rhs", "halo_src", "halo_slots",
          "halo_src_halo", "comm_matrix", "global_rhs")

CASES = [
    # (matrix, S, overlap, row_pad_multiple, dtype, weighted)
    ("lap12", 2, 2, 8, "float64", False),
    ("lap12", 4, 3, 8, "float64", False),
    ("lap12", 4, 4, 8, "float64", False),
    ("lap12", 3, 1, 8, "float32", False),
    ("lap3", 4, 2, 8, "float64", False),      # balanced split (n=9, S=4)
    ("lap128", 4, 2, 128, "float32", False),
    ("lap128", 8, 3, 128, "float32", False),
    ("lap12", 4, 2, 8, "float64", True),      # weighted regular blocks
    ("ani3", 2, 2, 8, "float64", False),
    ("ani4", 4, 3, 16, "float64", False),
]


def _matrix(kind, models):
    if kind.startswith("lap"):
        return models.laplacian_2d(int(kind[3:]))
    return models.read_mtx(models.matrix_path(f"{kind}_crop.mtx"))


def _both(kind, S, overlap, pad, dtype, weighted):
    out = []
    for models, cfg, dec in ((jmodels, jcfg, jdec), (tmodels, tcfg, tdec)):
        A = _matrix(kind, models)
        b = models.generate_rhs(A.n)
        w = (np.linspace(1.0, 3.0, A.n) if weighted else None)
        s = cfg.Settings(overlap=overlap, row_pad_multiple=pad, dtype=dtype)
        out.append(dec.decompose(A, b, s, S, cell_weights=w))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_decomposition_bit_identical(case):
    dj, dt = _both(*case)
    assert dataclasses.asdict(dj.meta) == dataclasses.asdict(dt.meta)
    for name in ARRAYS:
        a, b = getattr(dj, name), getattr(dt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for f in ("row_ptrs", "col_idxs", "values"):
        np.testing.assert_array_equal(getattr(dj.global_matrix, f),
                                      getattr(dt.global_matrix, f))
    for mj, mt in zip(dj.masks(), dt.masks()):
        np.testing.assert_array_equal(mj, mt)


@pytest.mark.parametrize("case", CASES[:7], ids=lambda c: "-".join(map(str, c)))
def test_dia_split_and_run_plan_identical(case):
    dj, dt = _both(*case)
    hj = jdia.split_dia_ell(dj.lmat_vals, dj.lmat_cols, dj.rows_count)
    ht = tdia.split_dia_ell(dt.lmat_vals, dt.lmat_cols, dt.rows_count)
    assert hj.offsets == ht.offsets
    assert hj.n_rows == ht.n_rows and hj.max_abs_offset == ht.max_abs_offset
    for f in ("dia_vals", "rem_rows", "rem_vals", "rem_cols"):
        np.testing.assert_array_equal(getattr(hj, f), getattr(ht, f))
    # entries of a diagonal that would leave [0, R) are zero
    R = ht.n_rows
    r = np.arange(R)
    for k, o in enumerate(ht.offsets):
        out = (r + o < 0) | (r + o >= R)
        assert not ht.dia_vals[:, k, out].any()
    # the JAX run plan's runs, slot by slot, give the port's segments
    r_ext, r_int = dj.meta.max_ext, dj.meta.max_interior
    rj = jex.build_run_plan(dj.halo_src_halo, dj.halo_slots, r_ext, r_int,
                            dj.interior_offset)
    if rj is not None:
        S = dj.meta.num_subdomains
        per = [[] for _ in range(S)]
        for L, srcs, dsts in zip(rj.lengths, rj.run_src, rj.run_dst):
            for s, k in zip(*np.nonzero(dsts < r_ext)):
                per[s] += [(dsts[s, k] + i, srcs[s, k] + i) for i in range(L)]
        H = max(map(len, per))
        slots = np.full((S, H), r_ext)
        src = np.zeros((S, H), np.int64)
        for s, pairs in enumerate(per):
            if pairs:
                slots[s, :len(pairs)], src[s, :len(pairs)] = zip(*pairs)
        from_runs = thk.build_segments(dt.interior_offset, r_int, r_ext,
                                       slots, src, S * r_int)
        for a, b in zip(from_runs, tex.segments_of(dt)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,S", [(10, 3), (9, 4), (100, 7), (64, 1)])
def test_partition_regular_identical(n, S):
    np.testing.assert_array_equal(jpart.partition_regular_1d(n, S),
                                  tpart.partition_regular_1d(n, S))
    w = np.abs(np.sin(np.arange(n))) + 0.1
    np.testing.assert_array_equal(jpart.partition_regular_1d(n, S, w),
                                  tpart.partition_regular_1d(n, S, w))


def test_flat_run_tables_cover_the_halo():
    """K2's segment table (the halo read from the gathered interiors)
    addresses exactly the halo slots of the decomposition, each with its
    source; a source outside the interiors is refused."""
    _, dt = _both("lap128", 4, 2, 128, "float32", False)
    r_ext, r_int = dt.meta.max_ext, dt.meta.max_interior
    segs, first = tex.segments_of(dt)
    lo = 0
    for s in range(4):
        pairs = sorted(
            (d + i, s0 + i)
            for d, n, kind, s0 in segs[lo:first[s, -1]] if kind == 2
            for i in range(n))
        lo = first[s, -1]
        valid = dt.halo_slots[s] < r_ext
        want = sorted(zip(dt.halo_slots[s][valid].tolist(),
                          dt.halo_src_halo[s][valid].tolist()))
        assert pairs == want
    with pytest.raises(ValueError):
        thk.build_segments(dt.interior_offset, r_int, r_ext, dt.halo_slots,
                           dt.halo_src_halo, r_int)


@pytest.mark.parametrize("part", [tcfg.Partition.regular2d,
                                  tcfg.Partition.metis])
def test_other_partitions_not_ported(part):
    """The regular 2-D and metis partitions, once refused by the port, take
    the generic decomposition path: bit-identical to the JAX package's."""
    decs = []
    for models, cfg, dec in ((jmodels, jcfg, jdec), (tmodels, tcfg, tdec)):
        A = models.laplacian_2d(8)
        s = cfg.Settings(partition=cfg.Partition(part.value))
        decs.append(dec.decompose(A, models.generate_rhs(A.n), s, 4))
    dj, dt = decs
    assert dataclasses.asdict(dj.meta) == dataclasses.asdict(dt.meta)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(dj, name), getattr(dt, name),
                                      err_msg=name)
