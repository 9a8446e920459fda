"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.  They
import neither JAX nor the JAX package, so on a machine without JAX run them
without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from functools import partial

import numpy as np
import pytest
import torch

from schwarz_tpu_torch import (CommSettings, ConvergenceSettings,
                               GlobalConvergence, HaloStrategy,
                               LocalCriterion, LocalSolver, Partition,
                               Precond, RASolver, Settings, solve)
from schwarz_tpu_torch import diagnostics as dg
from schwarz_tpu_torch.core.partition import partition_metis
from schwarz_tpu_torch.models import (advection_diffusion_2d,
                                      anisotropic_diffusion_2d, generate_rhs,
                                      laplacian_2d, matrix_path, read_mtx)
from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
from schwarz_tpu_torch.ops.async_ras_2d_kernel import (
    async_ras_2d_rounds, async_ras_2d_rounds_plain)
from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
from schwarz_tpu_torch.ops.async_ras_general_kernel import (
    async_general_rounds, async_general_rounds_plain)
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.ops.async_ras_kernel import (CLUSTER_SIZES,
                                                    async_ras_rounds,
                                                    async_ras_rounds_plain)
from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops.cluster_geometry import (ANY_CLUSTER_SIZES,
                                                    general_variant)
from schwarz_tpu_torch.ops.dia_kernel import (dia_spmv, dia_spmv_chain,
                                              dia_spmv_chain_plain,
                                              dia_spmv_plain, window_fits)
from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve, fused_cg_solve_plain
from schwarz_tpu_torch.ops.halo_kernel import (assemble_x_ext,
                                               assemble_x_ext_plain,
                                               build_segments)
from schwarz_tpu_torch.ops.rdma_kernel import (rdma_cyclic_shift,
                                               rdma_cyclic_shift_plain,
                                               rdma_exchange,
                                               rdma_exchange_plain)
from schwarz_tpu_torch.ops.rdma_kernel import exchange_rounds_plain
from schwarz_tpu_torch.parallel.exchange import segments_of
from schwarz_tpu_torch.parallel.neighbor_exchange import (build_neighbor_plan,
                                                          exchange_rounds)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _band(rng, S, R, offsets):
    """(S, K, R) diagonals with zeros where a diagonal leaves [0, R)."""
    dia = rng.standard_normal((S, len(offsets), R))
    r = np.arange(R)
    for k, o in enumerate(offsets):
        dia[:, k, (r + o < 0) | (r + o >= R)] = 0.0
    return dia


def test_build_all(dev):
    cuda_build.build_all()
    for name in cuda_build.KERNEL_SOURCES:
        assert cuda_build.library(name) is not None


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("offsets", [
    (-33, -1, 0, 1, 33),
    (0,),
    tuple(range(-6, 6)),           # more than 9 diagonals: run-time K
])
def test_dia_spmv_matches_plain(dev, dtype, rtol, offsets):
    rng = np.random.default_rng(0)
    S, R = 3, 1000
    dia = torch.tensor(_band(rng, S, R, offsets), dtype=dtype, device=dev)
    # a strided view, as the solver passes x_ext[:, :R_rows]
    x = torch.tensor(rng.standard_normal((S, R + 70)), dtype=dtype,
                     device=dev)[:, 3:3 + R + 50]
    n0 = dia_spmv.launches
    y = dia_spmv(offsets, dia, x)
    torch.cuda.synchronize()
    assert dia_spmv.launches == n0 + 1
    ref = dia_spmv_plain(offsets, dia, x)
    torch.testing.assert_close(y, ref, rtol=rtol, atol=rtol)


def _k2_case(case):
    """(x_own shape, r_ext, segs, first) of a K2 case: a regular strip
    plan (halo runs), an irregular metis halo (one-element runs), or
    synthetic tables whose rows, window offsets and run starts are no
    multiples of 4 (the edge paths of the 16-byte copies), with segments
    across tiles."""
    if case == "synthetic":
        S, r_int, r_ext = 3, 5001, 9003
        off = np.array([0, 1001, 3])
        # runs (src, dst) of lengths lens; r_ext = unused
        src = np.array([[5003, 5, 10001, 0], [1, 4099, 5001, 0],
                        [2, 9, 5005, 10005]])
        dst = np.array([[5001, 7001, 8999, r_ext], [1, 6002, 8999, r_ext],
                        [5004, 7003, 0, 8000]])
        lens = np.array([1999, 13, 3, 1])
        used = dst < r_ext
        within = [np.arange(n) for n in lens]
        slots = np.full((S, lens.sum()), r_ext)
        srcs = np.zeros((S, lens.sum()), np.int64)
        for s in range(S):
            slots[s, :lens[used[s]].sum()] = np.concatenate(
                [d + w for d, w, u in zip(dst[s], within, used[s]) if u])
            srcs[s, :lens[used[s]].sum()] = np.concatenate(
                [a + w for a, w, u in zip(src[s], within, used[s]) if u])
        return (S, r_int), r_ext, build_segments(
            off, r_int, r_ext, slots, srcs, S * r_int)
    A = laplacian_2d(64 if case == "regular" else 32)
    s = Settings(overlap=3, partition=Partition(case))
    dec = decompose(A, generate_rhs(A.n), s, 4 if case == "regular" else 8)
    m = dec.meta
    return ((m.num_subdomains, m.max_interior), m.max_ext, segments_of(dec))


def _k2_check(dev, x, halo_src, tables, r_ext, halo_dtype=None):
    segs, first = (torch.tensor(t, device=dev) for t in tables)
    n0 = assemble_x_ext.launches
    got = assemble_x_ext(x, halo_src, segs, first, r_ext, halo_dtype)
    torch.cuda.synchronize()
    assert assemble_x_ext.launches == n0 + 1
    ref = assemble_x_ext_plain(x, halo_src, segs, first, r_ext, halo_dtype)
    assert got.shape == (x.shape[0], r_ext) and got.is_contiguous()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("halo_dtype", [None, torch.float32, torch.float64,
                                        torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["regular", "metis", "synthetic"])
def test_halo_runs_bit_identical(dev, case, dtype, halo_dtype):
    """K2 with the halo as runs of the gathered interiors (all_gather),
    rounded through each halo type, against its plain version."""
    shape, r_ext, tables = _k2_case(case)
    x = torch.tensor(np.random.default_rng(1).standard_normal(shape),
                     dtype=dtype, device=dev)
    _k2_check(dev, x, x, tables, r_ext, halo_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_assembly_compact_bit_identical(dev, dtype):
    """K2 over the neighbour strategies' compact halo values."""
    A = laplacian_2d(32)
    dec = decompose(A, generate_rhs(A.n), Settings(
        overlap=2, partition=Partition.regular2d), 16)
    m = dec.meta
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (m.num_subdomains, m.max_interior)), dtype=dtype, device=dev)
    halo = exchange_rounds_plain(
        x, exchange_rounds(build_neighbor_plan(dec, 4), dev), None,
        lambda b, r: torch.roll(b, r, 0))
    _k2_check(dev, x, halo, segments_of(dec, compact=True), m.max_ext)


def test_halo_assembly_one_subdomain(dev):
    """S = 1: no halo, the window and zero padding only."""
    A = laplacian_2d(48)
    dec = decompose(A, generate_rhs(A.n), Settings(row_pad_multiple=1024), 1)
    m = dec.meta
    x = torch.randn((1, m.max_interior), device=dev, dtype=torch.float64)
    _k2_check(dev, x, x, segments_of(dec), m.max_ext)


def test_halo_assembly_refuses(dev):
    shape, r_ext, tables = _k2_case("synthetic")
    segs, first = (torch.tensor(t, device=dev) for t in tables)
    x = torch.zeros(shape, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        assemble_x_ext(x, x, segs, first, r_ext)
    x = x.float()
    with pytest.raises(TypeError, match="halo_dtype"):
        assemble_x_ext(x, x, segs, first, r_ext, torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        assemble_x_ext(x, x, segs, first, r_ext + 4096)


def _cg_args(dev, S, R, n1d, jacobi, shift=0.0):
    """A batched 5-point operator on (R / n1d, n1d) grids, diagonal
    4 + shift + s / 2 in subdomain s, and a random rhs that is zero in the
    last subdomain (which must never iterate)."""
    offsets = (-n1d, -1, 0, 1, n1d)
    r = np.arange(R)
    dia = np.zeros((S, 5, R))
    dia[:, 2] = 4.0 + shift + np.arange(S)[:, None] * 0.5
    for k, o in enumerate(offsets):
        if o:
            ok = (r + o >= 0) & (r + o < R)
            if abs(o) == 1:
                ok &= (r // n1d) == ((r + o) // n1d)
            dia[:, k, ok] = -1.0
    rng = np.random.default_rng(2)
    b = rng.standard_normal((S, R))
    b[S - 1] = 0.0
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    dinv = t(1.0 / dia[:, 2]) if jacobi else None
    return (offsets, t(dia), t(b), t(np.zeros((S, R))), dinv, 1e-5, 200)


def _cg_check(args, C, variant):
    n0 = fused_cg_solve.launches
    got = fused_cg_solve(*args, cluster=C)
    torch.cuda.synchronize()
    assert fused_cg_solve.launches == n0 + 1
    if C is not None:
        assert fused_cg_solve.cluster == C
    assert fused_cg_solve.variant == variant
    ref = fused_cg_solve_plain(*args)
    assert int(got.iters[-1]) == 0
    assert (got.iters - ref.iters).abs().max().item() <= 1
    torch.testing.assert_close(got.x, ref.x, rtol=0, atol=5e-4)


@pytest.mark.parametrize("C", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_cg_matches_plain(dev, jacobi, C):
    """K3 at the chosen cluster size and forced ones, the vectors in shared
    memory: x within float32 sum order of the plain CG, iterations within
    one, and the zero-rhs subdomain at 0 iterations."""
    _cg_check(_cg_args(dev, 4, 1024, 32, jacobi), C, "shared")


@pytest.mark.parametrize("C", [2, 4, 8])
def test_fused_cg_offsets_cross_chunks(dev, C):
    """Offsets of +-300 rows against chunks of 512, 256 and 128 rows: the
    product reads the next block's p, and at C = 8 a block two or three
    chunks away, through distributed shared memory."""
    _cg_check(_cg_args(dev, 3, 1024, 300, True, shift=0.5), C, "shared")


@pytest.mark.parametrize("C", [1, 2])
def test_fused_cg_global_memory_variant(dev, C):
    """32768 rows on 1 or 2 blocks do not fit shared memory: the same
    kernel keeps the vectors in device memory."""
    _cg_check(_cg_args(dev, 2, 32768, 128, True, shift=0.5), C, "global")


def test_fused_cg_refuses_a_cluster_it_cannot_hold(dev):
    args = _cg_args(dev, 2, 1024, 32, True)
    with pytest.raises(RuntimeError, match="clusters"):
        fused_cg_solve(*args, cluster=9)


def test_smoke_x2_matches_plain(dev):
    x = torch.randn((256, 256), device=dev)
    n0 = dg.smoke_x2.launches
    y = dg.smoke_x2(x)
    torch.cuda.synchronize()
    assert dg.smoke_x2.launches == n0 + 1
    assert torch.equal(y, dg.smoke_x2_plain(x))


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_flag_order_probe(dev, C):
    """K9 at the smoke run's size with producer and consumer clusters of C
    blocks: no mismatch, no watchdog, 2C distinct SMs."""
    res = dg.flag_order_probe(32768, 10000, dev, cluster=C)
    assert res == dict(res, mismatches=0, error=0, cluster=C)
    sms = res["producer_sms"] + res["consumer_sms"]
    assert len(sms) == 2 * C and len(set(sms)) == 2 * C
    assert dg.flag_order_probe_plain(1024, 100, cluster=C) == dict(
        mismatches=0, error=0, cluster=C, producer_sms=[-1] * C,
        consumer_sms=[-1] * C)


def test_flag_order_probe_chooses_a_cluster(dev, monkeypatch):
    """By default the largest size of which the card holds two clusters,
    and a pass records it; a ragged message (not a multiple of 4 floats)
    takes the scalar tail."""
    monkeypatch.setattr(dg, "_FLAG_ORDER_PASSED", {})
    res = dg.flag_order_probe(4099, 1000, dev)
    C = res["cluster"]
    assert C in ANY_CLUSTER_SIZES and res["mismatches"] == 0
    assert len(set(res["producer_sms"] + res["consumer_sms"])) == 2 * C
    assert dg.flag_order_passed(dev) == C
    with pytest.raises(RuntimeError, match="clusters"):
        dg.flag_order_probe(4096, 10, dev, cluster=9)


def test_fresh_read_refuses_a_cluster_above_the_probed_one(dev, monkeypatch):
    """K5 and K6 under fresh_read after a pass at C = 2 only: they run at
    C <= 2 and refuse a larger C, naming it."""
    monkeypatch.setattr(dg, "_FLAG_ORDER_PASSED", {})
    assert dg.flag_order_probe(4096, 1000, dev, cluster=2)["mismatches"] == 0
    ops, state, boost, opts = _k5(dev, "cg", staleness=3, fresh_read=True)
    with pytest.raises(NotImplementedFeature, match="C >= 4"):
        async_ras_rounds(*ops, *state, boost, **opts, cluster=4)
    async_ras_rounds(*ops, *state, boost, **opts, cluster=2)
    A = laplacian_2d(256)
    s = AsyncRASolver2D(A, np.ones(A.n), 2, 2, tolerance=1e-3, ninner=8,
                        staleness=3, chunk_rounds=4, fresh_read=True,
                        device=dev)
    X, known, aux = s.init_state()
    with pytest.raises(NotImplementedFeature, match="flag-order probe"):
        s.launch(s._fold(X), known, aux, cluster=3)
    s.launch(s._fold(X), known, aux, cluster=1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("op,D,kw", [
    ("lap64", 8, dict(tolerance=1e-4, ninner=20)),
    ("lap64", 1, dict(tolerance=1e-4, ninner=20)),          # Sl = 8 windows
    ("lap64", 2, dict(tolerance=1e-4, ninner=20, staleness=2)),
    ("lap64", 4, dict(tolerance=1e-4, ninner=10, oras_weight=-0.8)),
    ("adv32", 8, dict(tolerance=1e-4, ninner=10, nonsym=True)),
    ("adv32", 8, dict(tolerance=1e-4, ninner=10, nonsym=True,
                      nonsym_solver="gmres")),
])
def test_async_ras_matches_plain(dev, op, D, kw):
    """Two 16-round launches of K5 against the lockstep emulation.  Without
    fresh_read the rounds do not depend on timing, and both sides sum the
    same float32 products in float64 without FMA: equal up to ties."""
    A = laplacian_2d(64) if op == "lap64" else advection_diffusion_2d(32)
    s = AsyncRASolver(A, generate_rhs(A.n, random=False), 8, num_ranks=D,
                      chunk_rounds=16, device=dev, **kw)
    p, d = s.plan, s._dev
    x, known, aux, hl, hr = s.init_state()
    state = (x.reshape(D, -1), known, aux, hl, hr)
    opts = dict(offsets=p.offsets, total=p.total, hw=p.hw, rounds=16,
                staleness=s.staleness, ninner=s.ninner, tol=s.tolerance,
                nonsym=s.nonsym, nonsym_solver=s.nonsym_solver)
    ops = (d["dia"], d["b"], d["dinv"], d["mask_dom"], d["mask_int"])
    for _ in range(2):
        n0 = async_ras_rounds.launches
        got = async_ras_rounds(*ops, *state, d.get("boost"), **opts)
        torch.cuda.synchronize()
        assert async_ras_rounds.launches == n0 + 1
        ref = async_ras_rounds_plain(*ops, *state, d.get("boost"), **opts)
        scale = float(ref[0].abs().max())
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5 * scale)
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[2][:, 1:3], ref[2][:, 1:3])
        torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5 * scale)
        state = ref


_K5_CASES = {
    "cg": ("lap64", 8, dict(tolerance=1e-4, ninner=20)),
    "windows": ("lap64", 1, dict(tolerance=1e-4, ninner=20)),   # Sl = 8
    "staleness": ("lap64", 2, dict(tolerance=1e-4, ninner=20, staleness=2)),
    "oras": ("lap64", 4, dict(tolerance=1e-4, ninner=10, oras_weight=-0.8)),
    "bicgstab": ("adv32", 8, dict(tolerance=1e-4, ninner=10, nonsym=True)),
    "gmres": ("adv32", 8, dict(tolerance=1e-4, ninner=10, nonsym=True,
                               nonsym_solver="gmres")),
}


def _k5(dev, case, **extra):
    op, D, kw = _K5_CASES[case]
    A = laplacian_2d(64) if op == "lap64" else advection_diffusion_2d(32)
    s = AsyncRASolver(A, generate_rhs(A.n, random=False), 8, num_ranks=D,
                      chunk_rounds=16, device=dev, **{**kw, **extra})
    p, d = s.plan, s._dev
    x, known, aux, hl, hr = s.init_state()
    opts = dict(offsets=p.offsets, total=p.total, hw=p.hw, rounds=16,
                staleness=s.staleness, ninner=s.ninner, tol=s.tolerance,
                nonsym=s.nonsym, nonsym_solver=s.nonsym_solver,
                fresh_read=s.fresh_read)
    ops = (d["dia"], d["b"], d["dinv"], d["mask_dom"], d["mask_int"])
    return ops, (x.reshape(D, -1), known, aux, hl, hr), d.get("boost"), opts


@pytest.mark.parametrize("case", sorted(_K5_CASES))
@pytest.mark.parametrize("C", CLUSTER_SIZES)
def test_async_ras_cluster_matches_plain(dev, C, case):
    """Two 16-round launches of K5 with C blocks per rank, forced, against
    the lockstep emulation: the same check as at the chosen size (known
    bits and done_at equal, iterates within float32 ties)."""
    ops, state, boost, opts = _k5(dev, case)
    for _ in range(2):
        got = async_ras_rounds(*ops, *state, boost, **opts, cluster=C)
        torch.cuda.synchronize()
        assert async_ras_rounds.cluster == C
        ref = async_ras_rounds_plain(*ops, *state, boost, **opts)
        scale = float(ref[0].abs().max())
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5 * scale)
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[2][:, 1:3], ref[2][:, 1:3])
        torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5 * scale)
        state = ref


@pytest.mark.parametrize("C", CLUSTER_SIZES)
def test_async_ras_cluster_fresh_read_after_probe(dev, C):
    """fresh_read at staleness 3 with C blocks per rank: the leader's peek
    finds newer messages and every rank learns of convergence."""
    assert dg.flag_order_probe(4096, 1000, dev)["mismatches"] == 0
    ops, state, boost, opts = _k5(dev, "cg", staleness=3, fresh_read=True)
    for _ in range(50):
        state = async_ras_rounds(*ops, *state, boost, **opts, cluster=C)
        if bool((state[2][:, 1] >= 0).all()):
            break
    aux = state[2]
    assert bool((aux[:, 1] >= 0).all()) and float(aux[:, 4].sum()) > 0
    assert bool(torch.isfinite(state[0]).all())


def test_async_ras_chooses_a_cluster(dev):
    ops, state, boost, opts = _k5(dev, "cg")
    async_ras_rounds(*ops, *state, boost, **opts)
    assert async_ras_rounds.cluster in CLUSTER_SIZES
    with pytest.raises(RuntimeError, match="clusters"):
        async_ras_rounds(*ops, *state, boost, **opts, cluster=3)


def test_async_ras_converges_like_cpu(dev):
    A = laplacian_2d(64)
    kw = dict(tolerance=1e-4, ninner=20, chunk_rounds=16, num_ranks=8)
    b = np.ones(A.n)
    x_c, i_c = AsyncRASolver(A, b, 8, device=dev, **kw).run(max_rounds=800)
    x_h, i_h = AsyncRASolver(A, b, 8, device="cpu", **kw).run(max_rounds=800)
    assert i_c["converged"] and i_c["relative_residual_norm"] < 1e-3
    np.testing.assert_array_equal(i_c["done_at"], i_h["done_at"])
    np.testing.assert_allclose(x_c, x_h, rtol=0,
                               atol=1e-5 * np.abs(x_h).max())


def test_async_fresh_read_after_probe(dev):
    assert dg.flag_order_probe(4096, 1000, dev)["mismatches"] == 0
    A = laplacian_2d(64)
    s = AsyncRASolver(A, np.ones(A.n), 8, tolerance=1e-4, ninner=20,
                      staleness=3, chunk_rounds=16, fresh_read=True,
                      device=dev)
    _, info = s.run(max_rounds=800)
    assert info["converged"] and info["fresh_read_hits"] > 0
    assert info["relative_residual_norm"] < 1e-3


@pytest.mark.parametrize("op,px,py,D,kw", [
    ("lap256", 2, 2, 4, dict(tolerance=1e-3, ninner=8)),
    ("lap256", 4, 4, 4, dict(tolerance=1e-3, ninner=8)),   # 2 x 2 windows
    ("lap256", 4, 2, 1, dict(tolerance=1e-3, ninner=8)),   # self-messages
    ("lap256", 4, 2, 2, dict(tolerance=1e-3, ninner=8, staleness=2)),
    ("aniso128", 4, 2, 8, dict(tolerance=1e-3, ninner=10,
                               oras_weight=-0.8)),          # 9-point
    ("adv128", 2, 2, 4, dict(tolerance=1e-3, ninner=8, nonsym=True)),
])
@pytest.mark.parametrize("C", [None, 1, 2, 4])
def test_async_ras_2d_matches_plain(dev, op, px, py, D, kw, C):
    """Two 8-round launches of K6, at the chosen cluster size and forced
    ones, against the lockstep emulation.  Without fresh_read the rounds do
    not depend on timing, and both sides sum the same float32 products in
    float64 without FMA: equal up to ties."""
    A = {"lap256": lambda: laplacian_2d(256),
         "aniso128": lambda: anisotropic_diffusion_2d(128, eps=5.0,
                                                      theta=0.4),
         "adv128": lambda: advection_diffusion_2d(128)}[op]()
    s = AsyncRASolver2D(A, generate_rhs(A.n, random=False), px, py,
                        num_ranks=D, chunk_rounds=8, device=dev, **kw)
    X, known, aux = s.init_state()
    state = (s._fold(X), known, aux)
    for _ in range(2):
        n0 = async_ras_2d_rounds.launches
        got = s.launch(*state, cluster=C)
        torch.cuda.synchronize()
        assert async_ras_2d_rounds.launches == n0 + 1
        assert async_ras_2d_rounds.cluster in ANY_CLUSTER_SIZES
        if C is not None:
            assert async_ras_2d_rounds.cluster == C
        ref = s.launch(*state, fn=async_ras_2d_rounds_plain)
        scale = float(ref[0].abs().max())
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5 * scale)
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[2][:, 1:3], ref[2][:, 1:3])
        state = ref


def test_async_ras_2d_refuses_a_cluster_it_cannot_hold(dev):
    A = laplacian_2d(256)
    s = AsyncRASolver2D(A, np.ones(A.n), 2, 2, tolerance=1e-3, ninner=8,
                        chunk_rounds=4, device=dev)
    X, known, aux = s.init_state()
    with pytest.raises(RuntimeError, match="clusters"):
        s.launch(s._fold(X), known, aux, cluster=9)


def test_async_ras_2d_converges_like_cpu(dev):
    A = laplacian_2d(256)
    b = np.ones(A.n)
    kw = dict(px=4, py=2, tolerance=2e-3, ninner=30, chunk_rounds=20,
              num_ranks=8)
    x_c, i_c = AsyncRASolver2D(A, b, device=dev, **kw).run(max_rounds=400)
    x_h, i_h = AsyncRASolver2D(A, b, device="cpu", **kw).run(max_rounds=400)
    assert i_c["converged"] and i_c["relative_residual_norm"] < 1e-2
    assert len(np.unique(i_c["done_at"])) > 1
    np.testing.assert_array_equal(i_c["done_at"], i_h["done_at"])
    np.testing.assert_allclose(x_c, x_h, rtol=0,
                               atol=1e-5 * np.abs(x_h).max())


def test_async_2d_fresh_read_after_probe(dev):
    assert dg.flag_order_probe(4096, 1000, dev)["mismatches"] == 0
    A = laplacian_2d(256)
    s = AsyncRASolver2D(A, np.ones(A.n), 4, 2, tolerance=2e-3, ninner=30,
                        staleness=3, chunk_rounds=20, fresh_read=True,
                        device=dev)
    _, info = s.run(max_rounds=800)
    assert info["converged"] and info["fresh_read_hits"] > 0
    assert info["relative_residual_norm"] < 1e-2


_GENERAL = {
    "lap64": lambda: laplacian_2d(64),
    "aniso64": lambda: anisotropic_diffusion_2d(64, eps=5.0, theta=0.3),
    "adv64": lambda: advection_diffusion_2d(64),
    "ani3": lambda: read_mtx(matrix_path("ani3_crop.mtx")),
    "ani4": lambda: read_mtx(matrix_path("ani4_crop.mtx")),
}


@pytest.mark.parametrize("op,S,kw", [
    ("lap64", 16, dict(tolerance=1e-3, ninner=8)),
    ("lap64", 8, dict(tolerance=1e-3, ninner=8, staleness=2)),
    ("lap64", 3, dict(tolerance=1e-3, ninner=8, staleness=3)),
    ("aniso64", 32, dict(tolerance=1e-3, ninner=10, oras_weight=-0.8)),
    ("adv64", 8, dict(tolerance=1e-3, ninner=8, nonsym=True)),
    ("ani3", 4, dict(tolerance=1e-3, ninner=24)),
    ("ani4", 8, dict(tolerance=1e-3, ninner=24, staleness=2)),
    ("lap64", 1, dict(tolerance=1e-3, ninner=8)),   # no link at all
])
@pytest.mark.parametrize("variant", ["shared", "global"])
def test_async_general_matches_plain(dev, op, S, kw, variant):
    """Three 8-round launches of K7 with its data forced into shared or
    device memory against the lockstep emulation, the later ones from a
    carry.  The rounds do not depend on timing, and both sides do the same
    float32 operations in the same order, without FMA, with float64 sums:
    bit for bit.  Every case fits shared memory (one rank of the 64^2
    Laplacian, 221 184 bytes, near its edge)."""
    A = _GENERAL[op]()
    s = AsyncGeneralRASolver(A, np.ones(A.n), S, overlap=2,
                             part=partition_metis(A, S), chunk_rounds=8,
                             device=dev, **kw)
    state = s.init_state()
    fn = partial(async_general_rounds, variant=variant)
    for _ in range(3):
        n0 = async_general_rounds.launches
        got = s.launch(*state, fn=fn)
        torch.cuda.synchronize()
        assert async_general_rounds.launches == n0 + 1
        assert async_general_rounds.variant == variant
        assert async_general_rounds.threads == (512 if variant == "shared"
                                                else 1024)
        ref = s.launch(*state, fn=async_general_rounds_plain)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        state = ref


def test_async_general_takes_global_when_too_large(dev):
    """One rank of the 9-point 64^2 operator (Rext = 4096, K = 9: 319 488
    bytes) does not fit shared memory: the wrapper takes the global-memory
    variant by size, and refuses 'shared' when it is forced."""
    A = _GENERAL["aniso64"]()
    s = AsyncGeneralRASolver(A, np.ones(A.n), 1, overlap=2,
                             part=partition_metis(A, 1), chunk_rounds=8,
                             tolerance=1e-3, ninner=8, device=dev)
    assert general_variant(s.plan.Rext, s.plan.K, False) == "global"
    state = s.init_state()
    got = s.launch(*state)
    assert async_general_rounds.variant == "global"
    ref = s.launch(*state, fn=async_general_rounds_plain)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="shared memory"):
        s.launch(*state, fn=partial(async_general_rounds, variant="shared"))


def test_async_general_converges_like_cpu(dev):
    A = _GENERAL["ani3"]()
    b = np.ones(A.n)
    kw = dict(overlap=2, tolerance=1e-3, ninner=24, chunk_rounds=8,
              part=partition_metis(A, 4))
    x_c, i_c = AsyncGeneralRASolver(A, b, 4, device=dev, **kw).run(
        max_rounds=400)
    x_h, i_h = AsyncGeneralRASolver(A, b, 4, device="cpu", **kw).run(
        max_rounds=400)
    assert i_c["converged"] and i_c["relative_residual_norm"] < 5e-3
    np.testing.assert_array_equal(i_c["done_at"], i_h["done_at"])
    np.testing.assert_array_equal(x_c, x_h)


def test_async_general_refuses_what_it_cannot_take(dev):
    A = laplacian_2d(64)
    s = AsyncGeneralRASolver(A, np.ones(A.n), 4, part=partition_metis(A, 4),
                             device=dev)
    state = s.init_state()
    with pytest.raises(ValueError, match="contiguous"):
        s.launch(state[0].t().contiguous().t(), *state[1:])
    with pytest.raises(TypeError, match="dtype"):
        s.launch(state[0].double(), *state[1:])
    with pytest.raises(ValueError, match="shapes"):
        s.launch(state[0], state[1][:, :64].contiguous(), *state[2:])


# K4's five one-sided variants: mode, one by one, flush-local
_SHIFT_VARIANTS = [("put", False, False), ("get", False, False),
                   ("put", True, False), ("put", True, True),
                   ("get", True, True)]


@pytest.mark.parametrize("mode,one_by_one,flush_local", _SHIFT_VARIANTS)
@pytest.mark.parametrize("D,H,offset,dtype", [
    (16, 3072, 1, torch.float32),      # the slice's rounds
    (16, 3072, 15, torch.float64),
    (2, 7, 1, torch.float64),          # source and target are one rank
    (64, 333, 9, torch.float32),
    (5, 1, 3, torch.bfloat16),
    (132, 40, 131, torch.float16),     # a rank on every SM
])
def test_rdma_shift_matches_plain(dev, mode, one_by_one, flush_local, D, H,
                                  offset, dtype):
    rng = np.random.default_rng(D + H)
    buf = torch.tensor(rng.standard_normal((D, H)), device=dev).to(dtype)
    for _ in range(3):                 # fresh counters on every launch
        n0 = rdma_cyclic_shift.launches
        out, counts = rdma_cyclic_shift(buf, offset, mode, one_by_one,
                                        flush_local)
        torch.cuda.synchronize()
        assert rdma_cyclic_shift.launches == n0 + 1
        ref, ref_counts = rdma_cyclic_shift_plain(buf, offset, mode,
                                                  one_by_one, flush_local)
        assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
        assert torch.equal(counts, ref_counts)


def test_rdma_shift_refuses_what_it_cannot_take(dev):
    buf = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        rdma_cyclic_shift(buf.t().contiguous().t(), 1)
    with pytest.raises(TypeError, match="bytes"):
        rdma_cyclic_shift(buf.to(torch.int8), 1)
    with pytest.raises(RuntimeError, match="co-resident"):
        rdma_cyclic_shift(torch.zeros((100000, 1), device=dev), 1)


@pytest.mark.parametrize("comm,kw", [
    (dict(strategy=HaloStrategy.rdma, enable_put=True, enable_get=False),
     dict(partition=Partition.regular2d)),
    (dict(strategy=HaloStrategy.rdma, enable_one_by_one=True,
          flush_type="flush-local"), dict(partition=Partition.metis)),
    (dict(strategy=HaloStrategy.neighbor, overlap_comm=True),
     dict(partition=Partition.regular2d)),
    (dict(strategy=HaloStrategy.rdma, onesided=True, staleness=3),
     dict(partition=Partition.regular2d, halo_dtype="float32",
          tolerance=1e-4)),
    (dict(strategy=HaloStrategy.rdma), dict(convergence=ConvergenceSettings(
        method=GlobalConvergence.tree))),
    (dict(strategy=HaloStrategy.rdma), dict(convergence=ConvergenceSettings(
        method=GlobalConvergence.decentralized))),
])
def test_rdma_solve_on_card_like_cpu(dev, comm, kw):
    A = laplacian_2d(32)
    b = generate_rhs(A.n)
    s = Settings(**{**dict(overlap=2, tolerance=1e-6, max_iters=400,
                           comm=CommSettings(**comm)), **kw})
    n0 = rdma_cyclic_shift.launches
    r_c = solve(A, b, s, 16, device=dev, num_ranks=4)
    r_h = solve(A, b, s, 16, device="cpu", num_ranks=4)
    if comm["strategy"] == HaloStrategy.rdma:
        assert rdma_cyclic_shift.launches > n0
    assert r_c.converged and r_c.iters == r_h.iters
    np.testing.assert_allclose(r_c.global_resnorm_history,
                               r_h.global_resnorm_history, rtol=1e-8)


def _rdma_plan(dev, which):
    """The rdma slice's 1-D plan (16 strips on 16 ranks: 2 rounds) or phase
    19's (``laplacian_2d(32)``, ``regular2d``, 64 subdomains on 16 ranks: 6
    rounds), with random float64 interiors."""
    n, part, S = (64, "regular", 16) if which == "1-D" else (32, "regular2d",
                                                              64)
    A = laplacian_2d(n)
    dec = decompose(A, generate_rhs(A.n), Settings(
        partition=Partition(part), overlap=2), S)
    nx = build_neighbor_plan(dec, 16)
    x = torch.tensor(np.random.default_rng(S).standard_normal(
        (S, dec.meta.max_interior)), device=dev)
    return nx, exchange_rounds(nx, dev), x


@pytest.mark.parametrize("halo_dtype", [torch.float32, torch.float64,
                                        torch.bfloat16])
@pytest.mark.parametrize("which", ["1-D", "regular2d"])
@pytest.mark.parametrize("mode,one_by_one,flush_local", _SHIFT_VARIANTS)
def test_rdma_exchange_matches_plain(dev, mode, one_by_one, flush_local,
                                     which, halo_dtype):
    """One K4 launch for the whole exchange against the pack gathers, one
    plain shift per round and the unpack: halo values bit for bit, the
    per-round counts equal."""
    nx, rounds, x = _rdma_plan(dev, which)
    assert len(nx.offsets) == (2 if which == "1-D" else 6)
    n0 = rdma_cyclic_shift.launches
    halo, counts = rdma_exchange(x, rounds, halo_dtype, mode, one_by_one,
                                 flush_local)
    assert rdma_cyclic_shift.launches == n0 + 1
    ref, ref_counts = rdma_exchange_plain(x, rounds, halo_dtype, mode,
                                          one_by_one, flush_local)
    assert torch.equal(halo.view(torch.uint8), ref.view(torch.uint8))
    assert torch.equal(counts, ref_counts)


def test_rdma_exchange_carries_its_sequence_words(dev):
    """Exchanges in a row, of different kinds, on one set of counters that
    nothing resets: each sees its own counts, and the counters hold the
    running totals."""
    nx, rounds, x = _rdma_plan(dev, "regular2d")
    kinds = [("put", False, False), ("put", False, False),
             ("get", True, True), ("put", True, False), ("get", False, False)]
    for mode, one_by_one, flush_local in kinds:
        x = x + 1.0
        halo, counts = rdma_exchange(x, rounds, torch.float32, mode,
                                     one_by_one, flush_local)
        ref, ref_counts = rdma_exchange_plain(x, rounds, torch.float32, mode,
                                              one_by_one, flush_local)
        assert torch.equal(halo, ref) and torch.equal(counts, ref_counts)
    card = rounds._card
    assert card.totals == [3, 2, 2, 5]
    widths = torch.tensor([t.shape[1] for t in nx.send_idx], device=dev)
    seq = card.seq[:-2].reshape(2, len(nx.offsets), 16)
    assert torch.equal(seq[0], (3 + 2 * widths)[:, None].expand(-1, 16))
    assert bool((seq[1] == 2).all())
    assert int(card.seq[-2]) == 5 * 16 and int(card.seq[-1]) == 0


@pytest.mark.parametrize("offsets", [(-64, -1, 0), (0, 1, 64), (-1,), (1,)])
@pytest.mark.parametrize("R", [1000, 22528 // 16])
def test_dia_spmv_one_sided_offsets(dev, offsets, R):
    """The FSAI and ILU(0) factors' offset sets (lower only, upper only) at
    row counts that are not a multiple of K1's block."""
    rng = np.random.default_rng(1)
    dia = torch.tensor(_band(rng, 4, R, offsets), dtype=torch.float32,
                       device=dev)
    x = torch.tensor(rng.standard_normal((4, R)), dtype=torch.float32,
                     device=dev)
    y = dia_spmv(offsets, dia, x)
    torch.testing.assert_close(y, dia_spmv_plain(offsets, dia, x),
                               rtol=1e-5, atol=1e-5)


# K1's shapes: rows not a multiple of 4 (or 2), and K at compile time (1-9)
# and at run time (12, 32), with offsets reaching past both ends
_K1_OFFSETS = {
    1: (7,),
    3: (-512, -1, 0),
    5: (-512, -1, 0, 1, 512),
    9: (-300, -64, -8, -1, 0, 1, 8, 64, 300),
    12: tuple(range(-6, 6)),
    32: tuple(range(-40, 120, 5)),
}


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("K", sorted(_K1_OFFSETS))
@pytest.mark.parametrize("R", [1, 127, 1000, 1408, 21504])
def test_dia_spmv_shapes_match_plain(dev, R, K, dtype, rtol):
    """K1 at every row count and diagonal count it meets, x a strided view
    whose row stride ldx = R + 70 is not a multiple of 4 (the solver's
    x_ext[:, :R_rows] is such a view)."""
    offsets = _K1_OFFSETS[K]
    rng = np.random.default_rng(R + K)
    S = 3
    dia = torch.tensor(_band(rng, S, R, offsets), dtype=dtype, device=dev)
    x = torch.tensor(rng.standard_normal((S, R + 70)), dtype=dtype,
                     device=dev)[:, 1:1 + R]
    assert x.stride(0) % 4 != 0
    n0 = dia_spmv.launches
    y = dia_spmv(offsets, dia, x)
    torch.cuda.synchronize()
    assert dia_spmv.launches == n0 + 1
    torch.testing.assert_close(y, dia_spmv_plain(offsets, dia, x),
                               rtol=rtol, atol=rtol)


# (offsets_in, offsets_out): FSAI's G and G^T at the flagship, a wider band,
# unequal counts (K at run time), and one-sided offsets past both ends
_CHAIN = {
    "fsai": ((-512, -1, 0), (0, 1, 512)),
    "band": ((-33, -2, -1, 0), (0, 1, 2, 33)),
    "unequal": ((-64, 0), (0, 1, 64, 200)),
    "reach": ((-2000, -3, 0), (0, 5, 2000)),
}


@pytest.mark.parametrize("tile", [None, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(_CHAIN))
@pytest.mark.parametrize("R", [1, 127, 1000, 1408, 21504])
def test_dia_spmv_chain_bit_identical(dev, R, case, dtype, tile):
    """The chain equals two K1 launches bit for bit (the inner product read
    as zero outside [0, R)), and its plain version within 1e-5.  The
    diagonals are not zeroed where they leave [0, R), so a window row
    outside [0, R) that were not zero would show."""
    oi, oo = _CHAIN[case]
    rng = np.random.default_rng(R)
    S = 4
    di = torch.tensor(rng.standard_normal((S, len(oi), R)), dtype=dtype,
                      device=dev)
    do = torch.tensor(rng.standard_normal((S, len(oo), R)), dtype=dtype,
                      device=dev)
    x = torch.tensor(rng.standard_normal((S, R + 9)), dtype=dtype,
                     device=dev)[:, 3:3 + R]
    z = dia_spmv_chain(oi, di, oo, do, x, tile=tile)
    two = dia_spmv(oo, do, dia_spmv(oi, di, x))
    torch.cuda.synchronize()
    assert torch.equal(z, two)
    torch.testing.assert_close(z, dia_spmv_chain_plain(oi, di, oo, do, x),
                               rtol=1e-5, atol=1e-5)


def test_dia_spmv_chain_counts_as_one_launch(dev):
    """A chain is one K1 launch under its own key; a chain whose window
    does not fit shared memory runs as two single K1 launches, counted as
    such."""
    rng = np.random.default_rng(2)
    oi, oo = _CHAIN["fsai"]
    di, do = (torch.tensor(_band(rng, 2, 4096, o), dtype=torch.float32,
                           device=dev) for o in (oi, oo))
    x = torch.randn((2, 4096), device=dev)
    dia_spmv.launches_by = {}
    n0 = dia_spmv.launches
    dia_spmv_chain(oi, di, oo, do, x)
    assert dia_spmv.launches == n0 + 1
    assert dia_spmv.launches_by == {("chain", oi, oo, "float32"): 1}
    wide = (0, 1, 20000)
    assert not window_fits(wide, torch.float32, 256)
    R = 24576
    di, do = (torch.tensor(_band(rng, 1, R, o), dtype=torch.float32,
                           device=dev) for o in (oi, wide))
    x = torch.randn((1, R), device=dev)
    dia_spmv.launches_by = {}
    z = dia_spmv_chain(oi, di, wide, do, x)
    assert dia_spmv.launches == n0 + 3
    assert dia_spmv.launches_by == {(oi, "float32"): 1, (wide, "float32"): 1}
    assert torch.equal(z, dia_spmv(wide, do, dia_spmv(oi, di, x)))


def test_dia_spmv_refuses_what_it_cannot_take(dev):
    dia = torch.zeros((2, 3, 64), device=dev)
    x = torch.zeros((2, 64), device=dev)
    with pytest.raises(ValueError):
        dia_spmv((0, 1), dia, x)
    with pytest.raises(ValueError):
        dia_spmv((0, 1, 2), dia, x[:, :32])
    with pytest.raises(ValueError):
        dia_spmv_chain((0, 1, 2), dia, (0, 1, 2), dia, x, tile=0)
    with pytest.raises(ValueError):
        dia_spmv_chain((0, 1, 2), dia, (0, 1, 2), dia[:, :2], x)


_TWO_LEVEL = {
    # the flagship recipe at 64^2 (bench.py:531-539 with S = 4, q = 8)
    "flagship-analog": dict(
        overlap=6, tolerance=1e-8, max_iters=200, dtype="float64",
        local_compute_dtype="float32", local_tolerance=1e-6,
        local_max_iters=20, precond=Precond.fsai, row_pad_multiple=128,
        two_level=True, coarse_aggregates=8, coarse_space="spectral"),
    "ilu-aggregates": dict(overlap=3, tolerance=1e-8, max_iters=400,
                           precond=Precond.ilu, two_level=True,
                           coarse_aggregates=4, row_pad_multiple=64),
    "oras-fused-cg": dict(
        overlap=2, tolerance=1e-8, max_iters=300, oras_weight="auto",
        local_compute_dtype="float32", fused_local_cg=True,
        precond=Precond.jacobi, row_pad_multiple=128, local_tolerance=1e-6),
    # the second exchange of a two-level iteration through K4
    "rdma-two-level": dict(
        overlap=3, tolerance=1e-8, max_iters=400, two_level=True,
        oras_weight="auto", coarse_aggregates=2,
        comm=CommSettings(strategy=HaloStrategy.rdma)),
    "block-jacobi-cg-coarse": dict(
        overlap=3, tolerance=1e-8, max_iters=400, two_level=True,
        precond=Precond.block_jacobi, coarse_solver="cg",
        coarse_aggregates=2, row_pad_multiple=16),
}


@pytest.mark.parametrize("case", sorted(_TWO_LEVEL))
def test_two_level_and_oras_solve_on_card_like_cpu(dev, case, monkeypatch):
    """The preconditioners, O-RAS and the coarse space on the card: K1
    carries the banded factors' products, K3 the Robin-modified operator;
    the CPU run (the same DIA layout) gives the same iteration count."""
    monkeypatch.delenv("SCHWARZ_TPU_COARSE_CACHE", raising=False)
    A = laplacian_2d(64)
    b = generate_rhs(A.n)
    s = Settings(spmv_format="dia", **_TWO_LEVEL[case])
    k1, k3 = dia_spmv.launches, fused_cg_solve.launches
    k4 = rdma_cyclic_shift.launches
    r_c = solve(A, b, s, 4, device=dev)
    r_h = solve(A, b, s, 4, device="cpu")
    assert dia_spmv.launches > k1
    assert (fused_cg_solve.launches > k3) == s.fused_local_cg
    # K4 once per exchange: two per two-level iteration, one on the exit
    rdma = s.comm.strategy == HaloStrategy.rdma
    assert rdma_cyclic_shift.launches - k4 == (2 * r_c.iters + 1 if rdma
                                               else 0)
    assert r_c.converged and r_c.iters == r_h.iters
    assert r_c.relative_residual_norm <= 2e-8
    np.testing.assert_allclose(r_c.global_resnorm_history,
                               r_h.global_resnorm_history, rtol=1e-4,
                               atol=1e-8 * r_h.global_resnorm_history.max())


def test_two_level_refinement_on_card_like_cpu(dev):
    """Two-level free-running refinement through K5: the CPU run's
    restarts and residual (K5 equals its plain version bit for bit)."""
    A = laplacian_2d(64)
    b = np.ones(A.n)
    kw = dict(overlap=2, tolerance=1e-4, ninner=20, chunk_rounds=16,
              num_ranks=8)
    n0 = async_ras_rounds.launches
    _, i_c = AsyncRASolver(A, b, 8, **kw).run_refined(tol=1e-8,
                                                      coarse_q=4)
    _, i_h = AsyncRASolver(A, b, 8, device="cpu", **kw).run_refined(
        tol=1e-8, coarse_q=4)
    assert async_ras_rounds.launches > n0
    assert i_c["converged"] and i_c["restarts"] == i_h["restarts"]
    assert i_c["relative_residual_norm"] == i_h["relative_residual_norm"]


# the local solvers, dia_only and overlap_split on the card; float64, so
# card and CPU give equal counts and histories within 1e-8.  GMRES runs on
# 16^2 advection: on 32^2 the solution form amplifies a rounding-level
# difference three- to fourfold an outer iteration over 24 of them, to 1e-7
# even with locals solved to 1e-10 and to 1e-5 at 1e-6, where inner counts
# part late; the CPU against itself with the rhs perturbed by 1e-16 reads
# so too (tests/torch_card_readings.py)
_LOCAL = {
    "gmres": dict(local_solver="gmres", restart_iter=20, local_max_iters=40,
                  local_tolerance=1e-6, precond=Precond.jacobi),
    "cholesky": dict(local_solver="cholesky"),
    "cholesky-inverse": dict(local_solver="cholesky", direct_apply="inverse"),
    "cholesky-blocked": dict(local_solver="cholesky",
                             direct_apply="blocked", row_pad_multiple=64),
    "lu": dict(local_solver="lu"),
    "dia-only": dict(inner_operator="dia_only", partition=Partition.regular2d,
                     local_max_iters=20,
                     convergence=ConvergenceSettings(
                         criterion=LocalCriterion.residual_based)),
    "split-inverse": dict(local_solver="cholesky", direct_apply="inverse",
                          comm=CommSettings(overlap_split=True)),
    "split-cg": dict(local_max_iters=30,
                     comm=CommSettings(overlap_split=True)),
}


@pytest.mark.parametrize("case", sorted(_LOCAL))
def test_local_solvers_on_card_like_cpu(dev, case):
    """GMRES locals (K1 in the inner operator), the dense direct locals
    (torch.linalg on the card), dia_only and both overlap splits: the CPU
    run's counts and histories; K1 and K2 launch."""
    kw = dict(_LOCAL[case])
    problem = advection_diffusion_2d if case in ("gmres", "lu") else \
        laplacian_2d
    if "local_solver" in kw:
        kw["local_solver"] = LocalSolver(kw["local_solver"])
    A = problem(16 if case == "gmres" else 32)
    b = generate_rhs(A.n)
    s = Settings(overlap=3, tolerance=1e-6, max_iters=400, spmv_format="dia",
                 **kw)
    k1, k2 = dia_spmv.launches, assemble_x_ext.launches
    r_c = solve(A, b, s, 4, device=dev)
    r_h = solve(A, b, s, 4, device="cpu")
    assert dia_spmv.launches > k1 and assemble_x_ext.launches > k2
    assert r_c.converged and r_c.iters == r_h.iters
    np.testing.assert_allclose(r_c.global_resnorm_history,
                               r_h.global_resnorm_history, rtol=1e-8,
                               atol=1e-12 * r_h.global_resnorm_history.max())


@pytest.mark.parametrize("case", ["cg", "fused-cg", "rdma", "cholesky"])
def test_fgmres_on_card_like_cpu(dev, case):
    """FGMRES with its two exchanges an iteration: CG locals, the fused CG
    kernel (K3) in the preconditioner, the one-sided exchange (K4), and
    dense Cholesky locals; the CPU run's count and history."""
    kw = {"cg": {},
          "fused-cg": dict(local_compute_dtype="float32",
                           fused_local_cg=True, precond=Precond.jacobi,
                           row_pad_multiple=128, local_tolerance=1e-6),
          "rdma": dict(comm=CommSettings(strategy=HaloStrategy.rdma)),
          "cholesky": dict(local_solver=LocalSolver.direct_cholesky,
                           direct_apply="inverse")}[case]
    A = laplacian_2d(48)
    b = generate_rhs(A.n)
    s = Settings(overlap=3, tolerance=1e-8, max_iters=300, restart_iter=20,
                 spmv_format="dia", accelerator="fgmres", **kw)
    before = {f: f.launches for f in (dia_spmv, assemble_x_ext,
                                      fused_cg_solve, rdma_cyclic_shift)}
    r_c = solve(A, b, s, 8, device=dev, num_ranks=8)
    r_h = solve(A, b, s, 8, device="cpu", num_ranks=8)
    grew = {f: f.launches > n for f, n in before.items()}
    assert grew[dia_spmv] and grew[assemble_x_ext]
    assert grew[fused_cg_solve] == (case == "fused-cg")
    assert grew[rdma_cyclic_shift] == (case == "rdma")
    assert r_c.converged and r_c.iters == r_h.iters
    assert r_c.relative_residual_norm <= 1e-8
    rtol = 1e-4 if case == "fused-cg" else 1e-8
    np.testing.assert_allclose(r_c.global_resnorm_history,
                               r_h.global_resnorm_history, rtol=rtol,
                               atol=1e-12 * r_h.global_resnorm_history.max())


def test_checkpoints_resume_bit_for_bit_on_card(dev, tmp_path):
    """A stationary run and an FGMRES run stopped early with a checkpoint
    and resumed equal the uninterrupted runs bit for bit."""
    A = laplacian_2d(48)
    b = generate_rhs(A.n)
    s = Settings(overlap=3, tolerance=1e-8, max_iters=400, restart_iter=10,
                 spmv_format="dia")
    dec = decompose(A, b, s, 8)
    full = RASolver(dec, device=dev)
    short = RASolver(decompose(A, b, s.replace(max_iters=20), 8), device=dev)
    p = str(tmp_path / "st.npz")
    short.run(checkpoint_path=p)
    r0, r1 = full.run(), full.run(resume_state=full.load_checkpoint(p))
    np.testing.assert_array_equal(r1.global_resnorm_history,
                                  r0.global_resnorm_history)
    np.testing.assert_array_equal(r1.solution, r0.solution)
    pa = str(tmp_path / "fg.npz")
    short.run_accelerated(checkpoint_path=pa)
    a0 = full.run_accelerated()
    a1 = full.run_accelerated(resume_state=full.load_accel_checkpoint(pa))
    np.testing.assert_array_equal(a1.global_resnorm_history,
                                  a0.global_resnorm_history)
    np.testing.assert_array_equal(a1.solution, a0.solution)


def test_direct_factors_on_card_like_cpu(dev):
    """torch.linalg's factors and applies on the card against the CPU's,
    float64, within 1e-12 normwise."""
    from schwarz_tpu_torch.solvers import direct as d

    A = laplacian_2d(32)
    dec = decompose(A, generate_rhs(A.n), Settings(overlap=3), 4)
    vals = torch.from_numpy(dec.lmat_vals)
    cols = torch.from_numpy(dec.lmat_cols.astype(np.int64))
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        dec.local_rhs.shape))
    L_h = d.cholesky_factor(vals, cols)
    L_c = d.cholesky_factor(vals.to(dev), cols.to(dev))

    def close(c, h):
        return float((c.cpu() - h).norm() / h.norm()) <= 1e-12

    assert close(L_c, L_h)
    inv_h, inv_c = d.cholesky_inverse(L_h), d.cholesky_inverse(L_c)
    assert close(inv_c, inv_h)
    assert close(d.inverse_apply(inv_c, b.to(dev)), d.inverse_apply(inv_h, b))
    blk = d.pick_trisolve_block(L_h.shape[-1])
    assert close(d.blocked_cholesky_solve(L_c, d.block_diag_inverses(L_c, blk),
                                          b.to(dev)),
                 d.cholesky_solve(L_h, b))
    lu_h, lu_c = d.lu_factor(vals, cols), d.lu_factor(vals.to(dev),
                                                      cols.to(dev))
    assert close(d.lu_solve(lu_c, b.to(dev)), d.lu_solve(lu_h, b))


def test_mesh_two_processes_on_card(dev, tmp_path):
    """Two processes on the one card, over gloo with their CUDA tensors
    staged through pinned host memory (``tests/torch_mesh_worker.py``): the
    mesh primitives bit for bit, and each solve at the single-process card
    run's count, histories within 1e-8 (float32 locals: the worker's
    ``RTOL``)."""
    from torch_mesh_worker import BASE, CASES, RTOL, run_group

    outs = run_group(2, str(tmp_path), device="cuda", timeout_s=400)
    G = np.arange(24, dtype=np.float64).reshape(8, 3)
    for r in (-3, 1, 5):
        np.testing.assert_array_equal(
            np.concatenate([o[f"shift_{r}"] for o in outs]),
            np.roll(G, r, 0))
    A = laplacian_2d(16)
    b = generate_rhs(A.n, random=False)
    for name, kw in CASES[2].items():
        ref = solve(A, b, Settings(**BASE, **kw), 8, num_ranks=8)
        for o in outs:
            assert bool(o[f"{name}.converged"]), name
            assert int(o[f"{name}.iters"]) == ref.iters, name
            h = ref.global_resnorm_history
            np.testing.assert_allclose(o[f"{name}.global"], h,
                                       rtol=RTOL.get(name, 1e-8),
                                       atol=1e-12 * h.max(), err_msg=name)


def test_rdma_exchange_across_processes_on_card(dev, tmp_path):
    """K4 in each of 2 processes on the one card (``mesh.launch``), a
    rank's peers in the other process reached through the CUDA IPC window:
    five launches of every kind on one set of sequence words equal
    ``exchange_rounds_plain`` with ``Mesh.shift``, and the one-sided solve
    on 2 processes gives the two-sided one's history bit for bit
    (``tests/torch_mesh_async_worker.py``)."""
    from torch_mesh_async_worker import RDMA, run_group

    outs = run_group(2, str(tmp_path), "k4,rdma", device="cuda",
                     timeout_s=400)
    for o in outs:
        for i in range(5):
            assert bool(o[f"k4_{i}.equal"]), i
        assert int(o["k4.longest_wait_ns"]) > 0
        for v in RDMA:
            np.testing.assert_array_equal(o[f"rdma_{v}.global"],
                                          o["neighbor.global"], err_msg=v)


def test_free_running_across_processes_on_card(dev, tmp_path):
    """K5, K6 and K7 in each of 2 processes on the one card: ``done_at``
    and the round counts of the single-process plain runs on the CPU, x
    within float32 rounding of them; and ``run_refined`` to 1e-8."""
    from torch_mesh_async_worker import (FREE_1D, FREE_1D_ROUNDS, FREE_2D,
                                         FREE_2D_ROUNDS, FREE_GEN,
                                         FREE_GEN_ROUNDS, run_group)

    outs = run_group(2, str(tmp_path), "free", device="cuda", timeout_s=400)
    A16, A12 = laplacian_2d(16), laplacian_2d(12)
    b16 = generate_rhs(A16.n, random=False)
    refs = {
        "free_1d": AsyncRASolver(A16, b16, 4, num_ranks=4, device="cpu",
                                 **FREE_1D).run(max_rounds=FREE_1D_ROUNDS),
        "free_2d": AsyncRASolver2D(
            A16, np.random.default_rng(11).uniform(0.5, 1.5, A16.n),
            num_ranks=4, device="cpu", **FREE_2D).run(
                max_rounds=FREE_2D_ROUNDS),
        "free_general": AsyncGeneralRASolver(
            A12, np.ones(A12.n), 4, part=partition_metis(A12, 4),
            device="cpu", **FREE_GEN).run(max_rounds=FREE_GEN_ROUNDS),
    }
    for o in outs:
        for name, (x, info) in refs.items():
            np.testing.assert_array_equal(o[f"{name}.done_at"],
                                          info["done_at"], err_msg=name)
            assert int(o[f"{name}.rounds"]) == info["rounds"], name
            np.testing.assert_allclose(o[f"{name}.x"], x, rtol=0,
                                       atol=1e-5 * np.abs(x).max())
        assert float(o["refined.rel"]) <= 1e-8


def test_checkpoints_across_processes_on_card(dev, tmp_path):
    """Checkpoints written and read by 2 processes on the card: the
    synchronous solve, FGMRES and the 1-D free-running tier resume to
    their straight runs bit for bit."""
    from torch_mesh_async_worker import run_group

    outs = run_group(2, str(tmp_path), "ckpt", device="cuda", timeout_s=400)
    for o in outs:
        for a, b in (("ck_resumed", "ck_straight"),
                     ("fg_resumed", "fg_straight")):
            for k in ("iters", "global", "solution"):
                np.testing.assert_array_equal(o[f"{a}.{k}"], o[f"{b}.{k}"])
        for k in ("x", "done_at", "total_rounds"):
            np.testing.assert_array_equal(o[f"fr_resumed.{k}"],
                                          o[f"fr_straight.{k}"])
