"""K2, the assembly of the extended iterate ``x_ext``, on the CPU.

The segment tables that ``build_segments`` paints once per plan (zero, then
the interior window, then the halo), and the kernel's plain version, which
writes ``x_ext`` segment by segment from them, against the JAX package's
``x_ext`` bit for bit: the ``all_gather`` exchange (its gather path, its
run path and its fused Pallas path in interpret mode) for the halo as runs
of the gathered interiors, and ``assemble_x_ext`` for the neighbour
strategies' compact halo values; every halo type.  Then whole synchronous
solves through it against the JAX package (float64: equal iteration counts,
histories within rtol 1e-8 at outer tolerance 1e-6).  The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.ops.halo_pallas import assemble_x_ext_fused, build_tiled_plan
from schwarz_tpu.parallel import exchange as jex
from schwarz_tpu.parallel.mesh import SUBD_AXIS, make_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ops.halo_kernel import (HALO, TILE, WINDOW, ZERO,
                                               assemble_x_ext,
                                               assemble_x_ext_plain,
                                               build_segments)
from schwarz_tpu_torch.ops.rdma_kernel import exchange_rounds_plain
from schwarz_tpu_torch.parallel.exchange import (exchange_halo_allgather,
                                                 segments_of)
from schwarz_tpu_torch.parallel.neighbor_exchange import (build_neighbor_plan,
                                                          exchange_rounds)
from schwarz_tpu_torch.ras import RASolver as TSolver

# (matrix, subdomains, overlap, dtype, partition): a regular strip plan with
# halo runs, another, an irregular metis halo, a 2-D grid, a real matrix
DECS = [("lap32", 4, 2, "float64", "regular"),
        ("lap12", 4, 3, "float64", "regular"),
        ("lap16", 8, 2, "float64", "metis"),
        ("lap16", 4, 2, "float32", "regular2d"),
        ("ani3", 2, 3, "float32", "regular")]
# compute type and halo type, as Settings(dtype, halo_dtype) give them
HALO_TYPES = [("float64", None), ("float64", "float32"),
              ("float32", "bfloat16"), ("float32", "float16"),
              ("float64", "bfloat16")]


def _dec(kind, S, overlap, dtype, partition, pad=8):
    A = (jmodels.laplacian_2d(int(kind[3:])) if kind.startswith("lap")
         else jmodels.read_mtx(jmodels.matrix_path(f"{kind}_crop.mtx")))
    return jdecompose(A, jmodels.generate_rhs(A.n), jcfg.Settings(
        overlap=overlap, dtype=dtype, row_pad_multiple=pad,
        partition=jcfg.Partition(partition)), S)


def _x(dec, dtype, seed=6):
    shape = (dec.meta.num_subdomains, dec.meta.max_interior)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _expand(segs, first, r_ext):
    """Per slot of each row: its kind and source index, from the table."""
    S = first.shape[0]
    kind = np.full((S, r_ext), -1)
    src = np.zeros((S, r_ext), np.int64)
    lo = 0
    for s in range(S):
        for d, n, k, s0 in segs[lo:first[s, -1]]:
            kind[s, d:d + n] = k
            src[s, d:d + n] = s0 + np.arange(n) if k != ZERO else 0
        lo = first[s, -1]
    return kind, src


# ------------------------------------------------------------ the tables ----
@pytest.mark.parametrize("compact", [False, True], ids=["runs", "compact"])
@pytest.mark.parametrize("case", DECS, ids=[f"{c[0]}-{c[4]}" for c in DECS])
def test_segments_cover_each_row_in_order(case, compact):
    """Each row is cut into segments that follow each other from 0 to
    r_ext; ``first`` names the segment holding each tile's first column;
    the halo slots are those of the decomposition with their sources, the
    rest of the window reads x_own, everything else is zero; neighbouring
    segments never merge into one."""
    dec = _dec(*case)
    S, r_int, r_ext = (dec.meta.num_subdomains, dec.meta.max_interior,
                       dec.meta.max_ext)
    H = dec.halo_slots.shape[1]
    segs, first = segments_of(dec, compact)
    assert segs.dtype == first.dtype == np.int32
    assert first.shape == (S, -(-r_ext // TILE) + 1)
    lo = 0
    for s in range(S):
        row = segs[lo:first[s, -1]]
        assert row[0, 0] == 0 and (row[:, 1] > 0).all()
        np.testing.assert_array_equal(row[1:, 0], row[:-1, 0] + row[:-1, 1])
        assert row[-1, 0] + row[-1, 1] == r_ext
        for t in range(first.shape[1] - 1):
            d, n = segs[first[s, t], :2]
            assert first[s, t] >= lo and d <= t * TILE < d + n
        same = row[1:, 2] == row[:-1, 2]
        joins = row[:-1, 3] + row[:-1, 1] == row[1:, 3]
        assert not (same & ((row[1:, 2] == ZERO) | joins)).any()
        lo = first[s, -1]
    kind, src = _expand(segs, first, r_ext)
    valid = dec.halo_slots < r_ext
    rows = np.nonzero(valid)[0]
    slots = dec.halo_slots[valid]
    assert (kind[rows, slots] == HALO).all()
    want = (np.arange(S * H).reshape(S, H) if compact
            else dec.halo_src_halo)[valid]
    np.testing.assert_array_equal(src[rows, slots], want)
    assert (kind == HALO).sum() == valid.sum()
    j = np.arange(r_ext)
    off = dec.interior_offset[:, None]
    in_win = (j >= off) & (j < off + r_int)
    np.testing.assert_array_equal(kind == WINDOW, in_win & (kind != HALO))
    np.testing.assert_array_equal(
        np.where(kind == WINDOW, src, 0),
        np.where(kind == WINDOW, np.arange(S)[:, None] * r_int + j - off, 0))
    assert ((kind == ZERO) == (~in_win & (kind != HALO))).all()


def test_halo_overwrites_window_last_writer():
    """A halo slot inside the window (padding rows of a short subdomain)
    gets the halo value, as the JAX scatter after the window insert gives
    it; the window runs past r_ext and is cut there."""
    r_int, r_ext = 6, 10
    off = np.array([0, 5])
    # subdomain 0: slots 4-5 (in its window) and 8 from subdomain 1;
    # subdomain 1: slots 0-1 from subdomain 0, its window 5-10 cut at 10
    slots = np.array([[4, 5, 8, r_ext], [0, 1, r_ext, r_ext]])
    srcs = np.array([[6, 7, 9, 0], [2, 3, 0, 0]])
    segs, first = build_segments(off, r_int, r_ext, slots, srcs, 2 * r_int)
    x = np.arange(1.0, 13.0).reshape(2, 6)
    got = assemble_x_ext_plain(*_t(x, x, segs, first), r_ext).numpy()
    np.testing.assert_array_equal(got, [
        [1, 2, 3, 4, 7, 8, 0, 0, 10, 0],
        [3, 4, 0, 0, 0, 7, 8, 9, 10, 11]])
    xall = jnp.asarray(x.reshape(-1))
    ref = jex.assemble_x_ext(jnp.asarray(x), jnp.asarray(off),
                             jnp.asarray(slots), xall[jnp.asarray(srcs)],
                             r_ext)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # the same through the compact form
    segs_b, first_b = build_segments(off, r_int, r_ext, slots,
                                     np.arange(8).reshape(2, 4), slots.size)
    halo = x.reshape(-1)[srcs]
    np.testing.assert_array_equal(assemble_x_ext(
        *_t(x, halo, segs_b, first_b), r_ext).numpy(), got)


def test_build_segments_refuses_bad_tables():
    off, r_int, r_ext = np.array([0, 2]), 4, 8
    slots, srcs = np.array([[5, 6], [0, r_ext]]), np.array([[4, 0], [0, 0]])
    build_segments(off, r_int, r_ext, slots, srcs, 8)
    with pytest.raises(ValueError, match="written twice"):
        build_segments(off, r_int, r_ext, np.array([[5, 5], [0, r_ext]]),
                       srcs, 8)
    with pytest.raises(ValueError, match="outside"):     # past the source
        build_segments(off, r_int, r_ext, slots, np.array([[4, 8], [0, 0]]),
                       8)
    with pytest.raises(ValueError, match="outside"):     # a negative source
        build_segments(off, r_int, r_ext, slots, np.array([[4, -1], [0, 0]]),
                       8)
    with pytest.raises(ValueError, match="outside"):     # a negative slot
        build_segments(off, r_int, r_ext, np.array([[5, -1], [0, r_ext]]),
                       srcs, 8)


# ------------------------------------ form (a): runs of the gathered interiors
def _jax_allgather(dec, x, halo_dtype, runs, D=2):
    """The JAX package's all_gather exchange on a mesh of D devices: its
    gather path, or its run path with the run plan."""
    r_ext, r_int = dec.meta.max_ext, dec.meta.max_interior
    rp = (jex.build_run_plan(dec.halo_src_halo, dec.halo_slots, r_ext,
                             r_int, dec.interior_offset) if runs else None)
    tables = [] if rp is None else [jnp.asarray(t)
                                    for t in rp.run_src + rp.run_dst]
    n = 0 if rp is None else len(rp.lengths)
    hd = None if halo_dtype is None else jnp.dtype(halo_dtype)

    def f(x, off, slots, src, *tbl):
        rpa = None if rp is None else (rp.lengths, tbl[:n], tbl[n:])
        return jex.exchange_halo_allgather(x, off, slots, src, r_ext,
                                           halo_dtype=hd,
                                           run_plan_arrays=rpa)

    args = (jnp.asarray(x), jnp.asarray(dec.interior_offset.astype(np.int32)),
            jnp.asarray(dec.halo_slots), jnp.asarray(dec.halo_src_halo),
            *tables)
    mapped = jax.shard_map(f, mesh=make_mesh(jax.devices()[:D]),
                           in_specs=(P(SUBD_AXIS),) * len(args),
                           out_specs=P(SUBD_AXIS), check_vma=False)
    return np.asarray(jax.jit(mapped)(*args)), rp


@pytest.mark.parametrize("dtype,halo_dtype", HALO_TYPES,
                         ids=[f"{a}-{b}" for a, b in HALO_TYPES])
@pytest.mark.parametrize("case", DECS, ids=[f"{c[0]}-{c[4]}" for c in DECS])
def test_form_a_matches_jax_allgather(case, dtype, halo_dtype):
    """Against the JAX gather path and, where the halo has a run plan,
    the JAX run path, bit for bit."""
    dec = _dec(*case[:3], dtype, case[4])
    x = _x(dec, dtype)
    hd = None if halo_dtype is None else getattr(torch, halo_dtype)
    n0 = assemble_x_ext.launches
    got = exchange_halo_allgather(*_t(x), _t(*segments_of(dec)),
                                  dec.meta.max_ext, hd)
    assert assemble_x_ext.launches == n0     # CPU tensors: the plain version
    assert got.dtype == getattr(torch, dtype) and got.is_contiguous()
    for runs in (True, False):
        ref, rp = _jax_allgather(dec, x, halo_dtype, runs)
        if not runs or rp is not None:
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n1d,S,overlap", [(128, 4, 2), (128, 8, 3)])
def test_form_a_matches_fused_interpret(n1d, S, overlap):
    """The JAX package's TPU path, window insert and DMA kernel
    (``assemble_x_ext_fused``, interpret mode, 128-element tiles)."""
    dec = _dec(f"lap{n1d}", S, overlap, "float32", "regular", pad=128)
    r_ext, r_int = dec.meta.max_ext, dec.meta.max_interior
    rp = jex.build_run_plan(dec.halo_src_halo, dec.halo_slots, r_ext, r_int,
                            dec.interior_offset)
    tp = build_tiled_plan(rp, dec.interior_offset, r_int, r_ext, S, tile=128)
    x = _x(dec, np.float32)
    tables = tuple(jnp.asarray(t) for pair in zip(tp.src_t, tp.dst_t)
                   for t in pair)
    ref = np.asarray(assemble_x_ext_fused(
        jnp.asarray(x), jnp.asarray(x.reshape(-1)),
        jnp.asarray(dec.interior_offset.astype(np.int32)), tp, tables,
        interpret=True))
    got = exchange_halo_allgather(*_t(x), _t(*segments_of(dec)), r_ext)
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------ form (b): the neighbour strategies' values --
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case,D", [(DECS[0], 2), (DECS[2], 4), (DECS[3], 2),
                                    (DECS[3], 4)],
                         ids=["lap32-regular-2", "lap16-metis-4",
                              "lap16-regular2d-2", "lap16-regular2d-4"])
def test_form_b_matches_jax_assemble(case, D, dtype):
    """The compact table over the halo values of the neighbour rounds
    against the JAX package's window insert and halo scatter."""
    dec = _dec(*case[:3], dtype, case[4])
    r_ext = dec.meta.max_ext
    x = _x(dec, dtype)
    halo = exchange_rounds_plain(
        torch.from_numpy(x), exchange_rounds(build_neighbor_plan(dec, D),
                                             "cpu"),
        None, lambda b, r: torch.roll(b, r, 0)).numpy()
    ref = np.asarray(jex.assemble_x_ext(
        jnp.asarray(x), jnp.asarray(dec.interior_offset.astype(np.int32)),
        jnp.asarray(dec.halo_slots), jnp.asarray(halo), r_ext))
    got = assemble_x_ext(*_t(x, halo), *_t(*segments_of(dec, True)), r_ext)
    np.testing.assert_array_equal(got.numpy(), ref)


# --------------------------------------------------- whole synchronous solves
@pytest.mark.parametrize("strategy,partition", [
    ("all_gather", "regular"), ("all_gather", "metis"), ("rdma", "regular")])
def test_solve_through_k2_matches_jax(strategy, partition):
    def settings(cfg):
        return cfg.Settings(
            partition=cfg.Partition(partition), overlap=3, tolerance=1e-6,
            max_iters=300,
            comm=cfg.CommSettings(strategy=cfg.HaloStrategy(strategy)))

    Aj = jmodels.laplacian_2d(16)
    b = jmodels.generate_rhs(Aj.n)
    rj = JSolver(jdecompose(Aj, b, settings(jcfg), 8),
                 mesh=make_mesh(jax.devices()[:2])).run()
    rt = TSolver(tdecompose(tmodels.laplacian_2d(16), b, settings(tcfg), 8),
                 device="cpu", num_ranks=2).run()
    assert rj.converged and rt.iters == rj.iters
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=1e-8)
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=0, atol=1e-12)
