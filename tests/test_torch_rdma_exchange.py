"""K4's fused exchange and K5's cluster size, on the CPU: the plain version
of the one-launch exchange (``rdma_exchange_plain``) against the
``ppermute`` transport, its per-round counts, the kernel's own tables
(pack, unpack, windows) emulated with PyTorch ops, the argument checks, the
sequence words' reset after a fault, and the choice of blocks per rank.
The kernels themselves run in ``tests/test_torch_cuda.py`` on a card."""

import jax
import numpy as np
import pytest
import torch

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
import schwarz_tpu.models as jmodels
from schwarz_tpu.parallel.mesh import make_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
from schwarz_tpu_torch.ops import rdma_kernel as rk
from schwarz_tpu_torch.ops.async_ras_kernel import (CLUSTER_SIZES,
                                                    choose_cluster)
from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext
from schwarz_tpu_torch.parallel.exchange import segments_of
from schwarz_tpu_torch.parallel.neighbor_exchange import (
    build_neighbor_plan, exchange_halo_neighbor, exchange_rounds)
from schwarz_tpu_torch.ras import RASolver as TSolver

# mode, one by one, flush-local: the five one-sided variants
VARIANTS = [("put", False, False), ("get", False, False),
            ("put", True, False), ("put", True, True), ("get", True, True)]


def _case(partition, D, overlap=3, n=16, dtype=torch.float64):
    """A decomposition of ``laplacian_2d(n)`` (8 subdomains, 16 for
    ``regular2d``), its round tables for D ranks and random interiors."""
    S = 16 if partition == "regular2d" else 8
    A = laplacian_2d(n)
    dec = tdecompose(A, generate_rhs(A.n), tcfg.Settings(
        partition=tcfg.Partition(partition), overlap=overlap), S)
    nx = build_neighbor_plan(dec, D)
    rounds = exchange_rounds(nx, "cpu")
    meta = dec.meta
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (S, meta.max_interior)), dtype=dtype)
    return dec, nx, rounds, x


def _segments(dec):
    return tuple(map(torch.tensor, segments_of(dec, compact=True)))


def _x_ext(dec, x, halo):
    return assemble_x_ext(x, halo, *_segments(dec), dec.meta.max_ext)


def _neighbor(dec, rounds, x, halo_dtype, transport, variant=VARIANTS[0]):
    mode, one_by_one, flush_local = variant
    return exchange_halo_neighbor(
        x, _segments(dec), rounds,
        dec.meta.max_ext, halo_dtype=halo_dtype, transport=transport,
        rdma_mode=mode, rdma_one_by_one=one_by_one,
        rdma_flush_local=flush_local)


@pytest.mark.parametrize("dtype,halo_dtype", [
    (torch.float64, None), (torch.float32, None),
    (torch.float64, torch.float32), (torch.float64, torch.bfloat16),
    (torch.float32, torch.float16)])
@pytest.mark.parametrize("D", [8, 2])
@pytest.mark.parametrize("partition", ["regular", "regular2d", "metis"])
def test_plain_exchange_equals_ppermute(partition, D, dtype, halo_dtype):
    dec, nx, rounds, x = _case(partition, D, dtype=dtype)
    ref = _neighbor(dec, rounds, x, halo_dtype, "ppermute")
    halo, counts = rk.rdma_exchange_plain(x, rounds, halo_dtype)
    assert halo.dtype == dtype
    assert torch.equal(_x_ext(dec, x, halo), ref)
    # and through the rdma transport of the exchange
    assert torch.equal(_neighbor(dec, rounds, x, halo_dtype, "rdma"), ref)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("partition,D", [("regular", 8), ("regular2d", 4),
                                         ("metis", 2)])
def test_per_round_counts(partition, D, variant):
    mode, one_by_one, flush_local = variant
    _, nx, rounds, x = _case(partition, D)
    halo, counts = rk.rdma_exchange(x, rounds, None, mode, one_by_one,
                                    flush_local)
    n_rounds = len(nx.offsets)
    assert counts.dtype == torch.int32 and counts.shape == (n_rounds, D, 2)
    for k, t in enumerate(nx.send_idx):
        assert counts[k, :, 0].tolist() == [t.shape[1] if one_by_one
                                            else 1] * D
        assert counts[k, :, 1].tolist() == [int(mode == "get")] * D
    _, status = rk.rdma_exchange_launch(x, rounds, None, mode, one_by_one,
                                        flush_local)
    assert status.shape == (2 * n_rounds * D + 1,) and int(status[-1]) == 0
    assert torch.equal(rk.rdma_shift_finish([status])[0],
                       counts.reshape(-1, 2))


@pytest.mark.parametrize("halo_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("partition,D", [("regular", 8), ("regular2d", 4),
                                         ("regular2d", 16), ("metis", 2)])
def test_kernel_tables_reproduce_the_exchange(partition, D, halo_dtype):
    """What the kernel does with its tables, in PyTorch: each rank packs
    through the concatenated send table into its target's window of the
    round, then reads own-block offsets (>= 0) or window positions
    (-(1 + pos)) through the unpack table."""
    _, nx, rounds, x = _case(partition, D)
    card = rounds._card_tables()
    S, r_int = x.shape
    flat = x.reshape(D, -1)
    send = flat.to(halo_dtype) if halo_dtype is not None else flat
    win = torch.empty(card.window, dtype=send.dtype)
    for k, (off, H, base) in enumerate(card.rounds.tolist()):
        assert (off, H) == (nx.offsets[k] % D, nx.send_idx[k].shape[1])
        pk = rounds.pack[base: base + D * H].reshape(D, H).long()
        for d in range(D):
            dst = (d + off) % D
            win[base + dst * H: base + (dst + 1) * H] = send[d, pk[d]]
    src = rounds.unpack.long()
    rank_of = (torch.arange(S) // (S // D))[:, None]
    own = flat[rank_of, src.clamp(min=0)]
    crossed = win[(-1 - src).clamp(min=0)].to(x.dtype)
    halo = torch.where(src >= 0, own, crossed)
    ref, _ = rk.rdma_exchange_plain(x, rounds, halo_dtype)
    assert torch.equal(halo, ref)
    assert rounds.unpack.dtype == torch.int32 and rounds.pack.dtype == \
        torch.int32
    assert card.seq.shape == (2 * len(nx.offsets) * D + 2,)
    assert not card.seq.any() and card.totals == [0, 0, 0, 0]


def test_argument_checks():
    _, nx, rounds, x = _case("regular", 8)
    with pytest.raises(ValueError, match="mode"):
        rk.rdma_exchange_launch(x, rounds, mode="push")
    with pytest.raises(ValueError, match="subdomains"):
        rk.rdma_exchange_launch(x[:4], rounds)
    _, _, rounds2, _ = _case("regular", 2)
    with pytest.raises(ValueError, match="subdomains"):
        rk.rdma_exchange_launch(x[:6], rounds2)
    with pytest.raises(ValueError, match="mode"):
        rk.rdma_cyclic_shift(torch.zeros((4, 3)), 1, "push")
    with pytest.raises(ValueError, match=r"\(D, H\)"):
        rk.rdma_cyclic_shift(torch.zeros(4), 1)


def test_fault_drops_every_set_of_sequence_words():
    card = rk._Card([1, 3], [5, 2], 4, "cpu")
    card.seq.add_(7)
    card.totals = [3, 1, 2, 4]
    ok = torch.zeros(2 * 2 * 4 + 1, dtype=torch.int32)
    assert rk.rdma_shift_finish([ok])[0].shape == (8, 2)
    assert card.totals == [3, 1, 2, 4]
    bad = ok.clone()
    bad[-1] = 5
    with pytest.raises(RuntimeError, match="source rank's data"):
        rk.rdma_shift_finish([ok, bad])
    assert card.totals == [0, 0, 0, 0] and not card.seq.any()
    assert card.rounds.tolist() == [[1, 5, 0], [3, 2, 20]]


@pytest.mark.parametrize("D,fits,want", [
    (16, {8: 16, 4: 33, 2: 66, 1: 132}, 8),   # 16 clusters of 8 fit
    (16, {8: 15, 4: 30, 2: 66, 1: 132}, 4),   # they do not: 4
    (128, {8: 15, 4: 30, 2: 66, 1: 132}, 1),  # today's layout
    (8, {8: 15, 4: 30, 2: 66, 1: 132}, 8),
    (40, {8: 15, 4: 30, 2: 66, 1: 132}, 2),
    (133, {8: 15, 4: 30, 2: 66, 1: 132}, 0),  # not even single blocks
])
def test_cluster_choice(D, fits, want):
    assert CLUSTER_SIZES == (8, 4, 2, 1)
    assert choose_cluster(D, fits.__getitem__) == want


def test_halo_dtype_bfloat16_matches_jax():
    """The one-sided exchange with bfloat16 halos under a float64 solve
    against the JAX package: a 2-byte halo stalls the detection ratio near
    0.1, so the tolerance is 0.3 (reached in a few dozen iterations)."""
    kw = dict(overlap=3, tolerance=0.3, max_iters=300, halo_dtype="bfloat16")

    def settings(cfg):
        return cfg.Settings(
            partition=cfg.Partition.regular,
            comm=cfg.CommSettings(strategy=cfg.HaloStrategy.rdma), **kw)

    Aj = jmodels.laplacian_2d(16)
    b = jmodels.generate_rhs(Aj.n)
    rj = JSolver(jdecompose(Aj, b, settings(jcfg), 8),
                 mesh=make_mesh(jax.devices()[:2])).run()
    rt = TSolver(tdecompose(laplacian_2d(16), b, settings(tcfg), 8),
                 device="cpu", num_ranks=2).run()
    assert rj.converged and rt.converged and rt.iters == rj.iters
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=1e-5)
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=0, atol=1e-9)
