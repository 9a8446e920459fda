"""The general-graph tier's host side, the port against the JAX package on
the CPU: ``build_general_plan``.  The port keeps the extended operators in
padded ELL form and the pack/unpack tables as indices; ``dense()`` rebuilds
the JAX plan's dense operators and one-hot matrices, which must be
bit-identical, as must every vector of the plan.  No kernel runs here;
tests/test_torch_general_ras.py runs the rounds."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import schwarz_tpu.models as jmodels
import schwarz_tpu.models.fem as jfem
from schwarz_tpu.exceptions import NotImplementedFeature as JNIF
from schwarz_tpu.ops.async_ras_general import build_general_plan as jplan
import schwarz_tpu_torch
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.models.fem as tfem
from schwarz_tpu_torch.core.partition import (
    partition_metis,
    partition_regular_1d,
)
from schwarz_tpu_torch.exceptions import NotImplementedFeature as TNIF
from schwarz_tpu_torch.ops import async_ras_general as tgen
from schwarz_tpu_torch.ops.async_ras_general import build_general_plan as tplan

SCALARS = ("S", "N", "Rint", "H", "Rext", "SEG", "C")
VECTORS = ("b", "dinv", "mask_dom", "mask_int", "tgt_subd", "send_len",
           "gid", "scale", "n_int")

# name: (operator, S, how the partition is made, overlap)
CASES = {
    "lap12-metis4": ("lap2:12", 4, "metis", 2),
    "lap16-metis8": ("lap2:16", 8, "metis", 2),
    "ani3-metis4": ("ani3", 4, "metis", 2),
    "adv16-random": ("adv:16", 5, "random", 1),
    "lap3d12-strips": ("lap3:12", 8, "strips", 2),
}


def _pair(kind):
    if kind.startswith("lap2:"):
        n = int(kind[5:])
        return jmodels.laplacian_2d(n), tmodels.laplacian_2d(n)
    if kind.startswith("lap3:"):
        n = int(kind[5:])
        return jfem.laplacian_3d(n), tfem.laplacian_3d(n)
    if kind.startswith("adv:"):
        n = int(kind[4:])
        return (jfem.advection_diffusion_2d(n),
                tfem.advection_diffusion_2d(n))
    name = f"{kind}_crop.mtx"
    return (jmodels.read_mtx(jmodels.matrix_path(name)),
            tmodels.read_mtx(tmodels.matrix_path(name)))


def _partition(how, tm, S):
    if how == "metis":
        return partition_metis(tm, S)
    if how == "strips":
        return partition_regular_1d(tm.n, S)
    part = np.random.default_rng(23).integers(0, S, tm.n)
    part[:S] = np.arange(S)           # no empty part
    return part


@pytest.fixture(scope="module")
def plans():
    cache = {}

    def get(name, oras):
        if (name, oras) not in cache:
            kind, S, how, overlap = CASES[name]
            jm, tm = _pair(kind)
            part = _partition(how, tm, S)
            b = np.random.default_rng(7).uniform(0.5, 1.5, tm.n)
            cache[name, oras] = (
                jplan(jm, b, part, overlap, oras_weight=oras),
                tplan(tm, b, part, overlap, oras_weight=oras), tm, b)
        return cache[name, oras]
    return get


@pytest.mark.parametrize("oras", [0.0, -0.8])
@pytest.mark.parametrize("name", list(CASES))
def test_plan_bit_identical(plans, name, oras):
    pj, pt, _, _ = plans(name, oras)
    for f in SCALARS:
        assert getattr(pt, f) == getattr(pj, f), f
    for f in VECTORS:
        a, c = getattr(pj, f), getattr(pt, f)
        assert a.dtype == c.dtype and a.shape == c.shape, f
        np.testing.assert_array_equal(c, a, err_msg=f)
    for a, c in zip(pj.int_ids, pt.int_ids):
        np.testing.assert_array_equal(c, a)
    if oras:
        assert pt.boost.dtype == pj.boost.dtype
        np.testing.assert_array_equal(pt.boost, pj.boost)
        assert np.abs(pt.boost).max() > 0
    else:
        assert pj.boost is None and pt.boost is None
    A, OH, U = pt.dense()
    for a, c, f in ((pj.A, A, "A"), (pj.OH, OH, "OH"), (pj.U, U, "U")):
        assert a.dtype == c.dtype and a.shape == c.shape, f
        np.testing.assert_array_equal(c, a, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_index_tables_are_consistent(plans, name):
    """ELL entries in slot order without repeats; every message place that
    is sent is received; places past ``send_len`` are unused."""
    _, p, _, _ = plans(name, 0.0)
    assert p.cols.shape == p.vals.shape == (p.S, p.Rext, p.K)
    assert p.cols.dtype == np.int32 and p.vals.dtype == np.float32
    live = p.vals != 0
    assert live.sum(axis=2).max() == p.K
    # a row's live entries come first, in strictly increasing slot order
    assert not (live[:, :, 1:] & ~live[:, :, :-1]).any()
    both = live[:, :, 1:] & live[:, :, :-1]
    assert (np.diff(p.cols, axis=2)[both] > 0).all()
    assert not p.vals[p.mask_dom == 0].any()
    for s in range(p.S):
        for c in range(p.C):
            o = int(p.tgt_subd[s, c])
            n = int(p.send_len[s, c])
            assert (p.send_idx[s, c, :n] >= 0).all()
            assert (p.send_idx[s, c, n:] == -1).all()
            assert (p.send_idx[s, c, :n] < p.n_int[s]).all()
            if o == s:
                assert n == 0 and (p.recv_slot[s, c] == -1).all()
                continue
            # what I send on this colour is what my partner unpacks
            got = p.recv_slot[o, c] >= 0
            assert got.sum() == n and got[:n].all()
            np.testing.assert_array_equal(
                p.gid[s, p.send_idx[s, c, :n]],
                p.gid[o, p.Rint + p.recv_slot[o, c, :n]])
        # every true halo slot has exactly one source
        slots = p.recv_slot[s][p.recv_slot[s] >= 0]
        n_halo = int((p.gid[s, p.Rint:] >= 0).sum())
        np.testing.assert_array_equal(np.sort(slots), np.arange(n_halo))


def _metis_plan(n=12, S=4):
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n, random=False)
    return A, b, tplan(A, b, partition_metis(A, S), overlap=2)


def _exchange(p, xint):
    """Pack every rank's owned values through ``send_idx`` and land them in
    the partners' halos through ``recv_slot``."""
    halo = np.zeros((p.S, p.H))
    for s in range(p.S):
        for c in range(p.C):
            o = int(p.tgt_subd[s, c])
            if o == s:
                continue
            n = int(p.send_len[o, c])
            halo[s, p.recv_slot[s, c, :n]] = xint[o, p.send_idx[o, c, :n]]
    return halo


def _apply(p, s, v):
    return (p.vals[s].astype(np.float64) * v[p.cols[s]]).sum(axis=1)


def test_plan_tables_restrict_global_residual():
    # packing x through the index tables must reproduce the exact global
    # residual rows on every rank's interior
    A, b, p = _metis_plan()
    xg = np.random.default_rng(0).standard_normal(p.N)
    # the plan is symmetrically Jacobi-scaled: the tables operate on the
    # scaled unknown y = x / scale and produce the scaled residual Ds r
    yg = xg / p.scale
    xint = np.zeros((p.S, p.Rint))
    for s in range(p.S):
        xint[s, : p.n_int[s]] = yg[p.int_ids[s]]
    halo = _exchange(p, xint)
    rg = np.asarray(b) - A.to_scipy() @ xg
    for s in range(p.S):
        x_ext = np.concatenate([xint[s], halo[s]])
        r = p.mask_dom[s] * (p.b[s] - _apply(p, s, x_ext))
        # entries and rhs are rounded to float32
        np.testing.assert_allclose(
            r[: p.n_int[s]], (p.scale * rg)[p.int_ids[s]], rtol=0,
            atol=1e-5)


def test_plan_sync_ras_reaches_direct_solution():
    # synchronous RAS iterated through the tables with exact local solves
    # converges to A^-1 b (the fixed point the free-running kernel shares)
    A, b, p = _metis_plan()
    xstar = spla.spsolve(A.to_scipy().tocsc(), np.asarray(b))
    xint = np.zeros((p.S, p.Rint))
    dense = [p.dense_operator(s).astype(np.float64) for s in range(p.S)]
    for _ in range(200):
        halo = _exchange(p, xint)
        new = xint.copy()
        for s in range(p.S):
            x_ext = np.concatenate([xint[s], halo[s]])
            r = p.mask_dom[s] * (p.b[s] - dense[s] @ x_ext)
            # off-domain rows are built ZERO (they carry r = 0); complete
            # them with identity for the dense reference solve
            z = np.linalg.solve(dense[s] + np.diag(1.0 - p.mask_dom[s]), r)
            new[s] = xint[s] + z[: p.Rint]
        xint = new
    sol = np.zeros(p.N)
    for s in range(p.S):
        sol[p.int_ids[s]] = xint[s, : p.n_int[s]] * p.scale[p.int_ids[s]]
    np.testing.assert_allclose(sol, xstar, rtol=0,
                               atol=1e-5 * np.abs(xstar).max())


def test_edge_coloring_is_proper():
    _, _, p = _metis_plan(n=16, S=8)
    lacks = 0
    for s in range(p.S):
        real = [int(p.tgt_subd[s, c]) for c in range(p.C)
                if p.tgt_subd[s, c] != s]
        lacks += p.C - len(real)
        assert len(real) == len(set(real)), "one link per partner"
        # symmetry: my partner on color c has me on color c
        for c in range(p.C):
            o = int(p.tgt_subd[s, c])
            if o != s:
                assert int(p.tgt_subd[o, c]) == s
    assert lacks > 0          # some rank lacks a colour at this size


@pytest.mark.parametrize("gate", ["ranks", "shape", "empty", "oras"])
def test_plan_gates_match(gate):
    jm, tm = jmodels.laplacian_2d(12), tmodels.laplacian_2d(12)
    b = np.ones(tm.n)
    part = partition_regular_1d(tm.n, 4)
    kw = {}
    if gate == "ranks":
        part = np.arange(tm.n)                       # 144 parts > 128
        types, match = (JNIF, TNIF), "one lane per rank: S <= 128"
    elif gate == "shape":
        part = part[:-1]
        types, match = (ValueError, ValueError), "partition shape"
    elif gate == "empty":
        part = np.where(part == 2, 3, part)
        types, match = (ValueError, ValueError), "empty subdomain"
    else:
        kw = dict(oras_weight=0.5)
        types, match = (ValueError, ValueError), r"outside \[-1, 0\]"
    messages = []
    for build, m, t in ((jplan, jm, types[0]), (tplan, tm, types[1])):
        with pytest.raises(t, match=match) as e:
            build(m, b, part, 2, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_package_exports_general_tier():
    assert schwarz_tpu_torch.AsyncGeneralRASolver is tgen.AsyncGeneralRASolver
    assert schwarz_tpu_torch.build_general_plan is tgen.build_general_plan
