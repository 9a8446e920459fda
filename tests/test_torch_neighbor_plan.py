"""The port's neighbour-exchange tables and rounds against the JAX package's,
on the CPU: ``build_neighbor_plan`` field by field, ``exchange_halo_neighbor``
against the ``all_gather`` exchange, and the plain version of K4 (the
one-sided cyclic shift) against ``np.roll`` and its counters."""

import dataclasses

import numpy as np
import pytest
import torch

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.models import generate_rhs, laplacian_2d
from schwarz_tpu.parallel.neighbor_exchange import (
    build_neighbor_plan as jbuild)
import schwarz_tpu_torch.config as tcfg
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ops.rdma_kernel import (rdma_cyclic_shift,
                                               rdma_cyclic_shift_plain,
                                               rdma_shift_finish,
                                               rdma_shift_launch)
from schwarz_tpu_torch.parallel.exchange import (exchange_halo_allgather,
                                                 segments_of)
from schwarz_tpu_torch.parallel.neighbor_exchange import (
    NeighborPlan, build_neighbor_plan, exchange_halo_neighbor,
    exchange_rounds)

# the five one-sided variants of tests/test_exchange.py
VARIANTS = [
    ("put", False, False),
    ("get", False, False),
    ("put", True, False),
    ("put", True, True),
    ("get", True, True),
]


def _decs(partition, overlap, n=16):
    """The same decomposition in both packages: 8 subdomains, or 16 for
    ``regular2d``, which needs a square count."""
    S = 16 if partition == "regular2d" else 8
    A = laplacian_2d(n)
    b = generate_rhs(A.n)
    dj = jdecompose(A, b, jcfg.Settings(
        partition=jcfg.Partition(partition), overlap=overlap), S)
    dt = tdecompose(A, b, tcfg.Settings(
        partition=tcfg.Partition(partition), overlap=overlap), S)
    return dj, dt


def _assert_plans_equal(pj, pt: NeighborPlan):
    for f in dataclasses.fields(NeighborPlan):
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if f.name == "send_idx":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("overlap", [2, 3])
@pytest.mark.parametrize("D", [8, 4, 2])
@pytest.mark.parametrize("partition", ["regular", "regular2d", "metis"])
def test_neighbor_plan_bit_identical(partition, D, overlap):
    dj, dt = _decs(partition, overlap)
    _assert_plans_equal(jbuild(dj, D), build_neighbor_plan(dt, D))


@pytest.mark.parametrize("partition", ["regular", "regular2d", "metis"])
@pytest.mark.parametrize("D,process_of", [
    (8, [0, 0, 0, 0, 1, 1, 1, 1]),
    (4, [0, 1, 0, 1]),
    (4, [0, 0, 0, 0]),
])
def test_neighbor_plan_two_hosts(partition, D, process_of):
    """Rounds that stay inside a host come first; the tables follow."""
    dj, dt = _decs(partition, 3)
    pj = jbuild(dj, D, process_of=process_of)
    pt = build_neighbor_plan(dt, D, process_of=process_of)
    _assert_plans_equal(pj, pt)
    assert pt.round_is_dcn == sorted(pt.round_is_dcn)
    if len(set(process_of)) == 1:
        assert not any(pt.round_is_dcn)
        assert pt.offsets == sorted(pt.offsets)
    else:
        assert any(pt.round_is_dcn)


def _exchange_both(dt, D, dtype, halo_dtype, transport, variant=VARIANTS[0]):
    """x_ext by the neighbour rounds and by the all_gather exchange, from
    the same random interiors."""
    meta = dt.meta
    S, R_int, R_ext = meta.num_subdomains, meta.max_interior, meta.max_ext
    rng = np.random.default_rng(5)
    x_own = torch.tensor(rng.standard_normal((S, R_int)), dtype=dtype)
    nx = build_neighbor_plan(dt, D)
    mode, one_by_one, flush_local = variant
    got = exchange_halo_neighbor(
        x_own, tuple(map(torch.tensor, segments_of(dt, compact=True))),
        exchange_rounds(nx, "cpu"), R_ext, halo_dtype=halo_dtype,
        transport=transport, rdma_mode=mode, rdma_one_by_one=one_by_one,
        rdma_flush_local=flush_local)
    ref = exchange_halo_allgather(
        x_own, tuple(map(torch.tensor, segments_of(dt))), R_ext,
        halo_dtype=halo_dtype)
    return got, ref, nx


@pytest.mark.parametrize("dtype,halo_dtype", [
    (torch.float64, None), (torch.float32, None),
    (torch.float64, torch.float32)])
@pytest.mark.parametrize("D", [8, 2])
@pytest.mark.parametrize("partition", ["regular", "regular2d", "metis"])
def test_exchange_neighbor_equals_allgather(partition, D, dtype, halo_dtype):
    _, dt = _decs(partition, 3)
    got, ref, nx = _exchange_both(dt, D, dtype, halo_dtype, "ppermute")
    assert got.dtype == dtype and got.shape == ref.shape
    if halo_dtype is None or dt.meta.num_subdomains == D:
        assert torch.equal(got, ref)
    else:
        # slots owned by another subdomain of the same rank never cross the
        # transport, so they keep full precision where all_gather rounds
        differs = got != ref
        assert differs.any()
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
        slots = torch.tensor(dt.halo_slots.astype(np.int64))
        local = torch.zeros((got.shape[0], got.shape[1] + 1),
                            dtype=torch.bool)
        local.scatter_(1, slots, torch.tensor(nx.is_local))
        assert not (differs & ~local[:, :-1]).any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_exchange_rdma_equals_allgather(variant):
    _, dt = _decs("regular2d", 2)
    got, ref, _ = _exchange_both(dt, 4, torch.float64, None, "rdma", variant)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("D,H,offset", [(2, 5, 1), (16, 24, 15), (7, 3, 3)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_shift_is_roll_with_counters(variant, D, H, offset, dtype):
    mode, one_by_one, flush_local = variant
    rng = np.random.default_rng(D * 100 + H)
    buf_np = rng.standard_normal((D, H))
    buf = torch.tensor(buf_np).to(dtype)
    out, counts = rdma_cyclic_shift(buf, offset, mode, one_by_one,
                                    flush_local)
    ref, ref_counts = rdma_cyclic_shift_plain(buf, offset, mode, one_by_one,
                                              flush_local)
    assert torch.equal(out, ref) and torch.equal(counts, ref_counts)
    want = np.roll(buf.to(torch.float64).numpy(), offset, axis=0)
    np.testing.assert_array_equal(out.to(torch.float64).numpy(), want)
    for d in range(D):
        np.testing.assert_array_equal(want[(d + offset) % D],
                                      buf[d].to(torch.float64).numpy())
    assert counts.dtype == torch.int32 and counts.shape == (D, 2)
    assert counts[:, 0].tolist() == [H if one_by_one else 1] * D
    assert counts[:, 1].tolist() == [1 if mode == "get" else 0] * D


def test_shift_launch_and_finish_on_cpu():
    buf = torch.arange(12.0).reshape(4, 3)
    n0 = rdma_cyclic_shift.launches
    out, status = rdma_shift_launch(buf, -1, "get")
    assert rdma_cyclic_shift.launches == n0        # no kernel on the CPU
    assert torch.equal(out, torch.roll(buf, 3, 0))
    assert status.shape == (9,) and int(status[-1]) == 0
    (counts,) = rdma_shift_finish([status])
    assert counts.tolist() == [[1, 1]] * 4
    status[-1] = 5
    with pytest.raises(RuntimeError, match="watchdog"):
        rdma_shift_finish([status])
    with pytest.raises(ValueError, match="mode"):
        rdma_cyclic_shift(buf, 1, "push")
    with pytest.raises(ValueError, match=r"\(D, H\)"):
        rdma_cyclic_shift(buf.reshape(-1), 1)
