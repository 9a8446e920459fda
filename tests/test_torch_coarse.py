"""The port's host coarse space (``core/coarse.py``) and the coarse entries
of its solver's plan against the JAX package's, on the CPU.

Both packages run the same numpy and scipy code in this process, so at the
sizes where every block takes the same branch (dense ``eigh`` at 64 rows
or fewer; the seeded in-process ARPACK below the pool's work threshold)
the bases, prolongators, coarse matrices and coarse solves agree bit for
bit.  A cache file written by either package is read by the other.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import schwarz_tpu.config as jcfg
import schwarz_tpu.core.coarse as jco
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.models.fem import advection_diffusion_2d
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.core.coarse as tco
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import RASolver as TSolver

# (n of laplacian_2d(n), strips, q): 48-row blocks take dense eigh; 256-row
# and 1024-row blocks the serial seeded ARPACK
SIZES = [(12, 3, 4), (16, 1, 1), (32, 4, 8), (64, 4, 8)]


def _operator(n):
    return tmodels.laplacian_2d(n).to_scipy()


@pytest.mark.parametrize("n,S,q", SIZES)
def test_neumann_spectral_vectors_bit_for_bit(n, S, q, monkeypatch):
    monkeypatch.delenv("SCHWARZ_TPU_COARSE_CACHE", raising=False)
    A = _operator(n)
    bnd = tco.equal_strip_boundaries(A.shape[0], S)
    got = tco.neumann_spectral_vectors(A, bnd, q)
    want = jco.neumann_spectral_vectors(A, bnd, q)
    assert len(got) == len(want) == S
    for g, w in zip(got, want):
        assert g.shape == w.shape == (A.shape[0] // S, min(q, A.shape[0]))
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,S,q", SIZES)
def test_prolongator_and_host_coarse_bit_for_bit(n, S, q, monkeypatch):
    monkeypatch.delenv("SCHWARZ_TPU_COARSE_CACHE", raising=False)
    A = _operator(n)
    bnd = tco.equal_strip_boundaries(A.shape[0], S)
    vecs = tco.neumann_spectral_vectors(A, bnd, q)
    Vt = tco.build_prolongator(vecs, bnd, A.shape[0], q)
    Vj = jco.build_prolongator(vecs, bnd, A.shape[0], q)
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(Vt, a), getattr(Vj, a))
    assert Vt.shape == Vj.shape == (A.shape[0], S * q)
    r = np.random.default_rng(3).standard_normal(A.shape[0])
    ct, cj = tco.HostCoarse(A, bnd, q), jco.HostCoarse(A, bnd, q)
    np.testing.assert_array_equal(ct.A_c, cj.A_c)
    np.testing.assert_array_equal(ct.solve(r), cj.solve(r))


def test_prolongator_pads_short_subdomains():
    # a 3-row subdomain at q = 4: its fourth column stays zero
    A = _operator(4)[:7, :7]
    bnd = np.array([0, 3, 7])
    vecs = tco.neumann_spectral_vectors(A, bnd, 4)
    assert [v.shape for v in vecs] == [(3, 3), (4, 4)]
    V = tco.build_prolongator(vecs, bnd, 7, 4)
    assert V.shape == (7, 8) and not V[:, 3].toarray().any()
    np.testing.assert_array_equal(
        V.toarray(), jco.build_prolongator(vecs, bnd, 7, 4).toarray())


@pytest.mark.parametrize("n,S", [(10, 3), (100, 7), (64, 64), (5, 8)])
def test_equal_strip_boundaries(n, S):
    np.testing.assert_array_equal(tco.equal_strip_boundaries(n, S),
                                  jco.equal_strip_boundaries(n, S))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_shared(writer, tmp_path, monkeypatch):
    """One package writes the basis to the cache, the other reads that
    very file (its name is the same key) and not a basis of its own."""
    monkeypatch.setenv("SCHWARZ_TPU_COARSE_CACHE", str(tmp_path))
    A = _operator(32)
    bnd = tco.equal_strip_boundaries(A.shape[0], 4)
    first, second = (jco, tco) if writer == "jax" else (tco, jco)
    path = first._coarse_cache_path(A.tocsr(), bnd, 8)
    assert path == second._coarse_cache_path(A.tocsr(), bnd, 8)
    want = first.neumann_spectral_vectors(A, bnd, 8)
    # mark the cached basis: the reader must return the file's contents
    with np.load(path) as z:
        marked = {k: z[k] * 2.0 for k in z.files}
    np.savez_compressed(path, **marked)
    got = second.neumann_spectral_vectors(A, bnd, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, 2.0 * w)


# the coarse entries of the solver's plan: the Galerkin matrix of the
# aggregates, the spectral basis in the inner dtype, the dense inverse in
# the inner dtype, the CG form's matrix in the outer dtype
PLAN_CASES = {
    "aggregates-q1": dict(coarse_aggregates=1),
    "aggregates-q4": dict(coarse_aggregates=4, row_pad_multiple=64),
    "spectral-q4": dict(coarse_space="spectral", coarse_aggregates=4),
    "spectral-f32": dict(coarse_space="spectral", coarse_aggregates=8,
                         local_compute_dtype="float32",
                         row_pad_multiple=128),
    "aggregates-cg": dict(coarse_aggregates=2, coarse_solver="cg"),
    "spectral-cg-f32": dict(coarse_space="spectral", coarse_aggregates=2,
                            coarse_solver="cg", dtype="float32"),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_coarse_plan_bit_for_bit(case, monkeypatch):
    monkeypatch.delenv("SCHWARZ_TPU_COARSE_CACHE", raising=False)
    A = tmodels.laplacian_2d(24)
    b = tmodels.generate_rhs(A.n)
    kw = dict(PLAN_CASES[case], overlap=3, two_level=True)
    js = JSolver(jdecompose(A, b, jcfg.Settings(**kw), 4))
    ts = TSolver(tdecompose(A, b, tcfg.Settings(**kw), 4), device="cpu")
    keys = [k for k in ("coarse_basis", "coarse_inv", "coarse_mat")
            if k in js._plan]
    assert keys == [k for k in ("coarse_basis", "coarse_inv", "coarse_mat")
                    if k in ts._plan]
    for k in keys:
        want = np.asarray(js._plan[k])
        got = ts._plan[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _exact_coarse_inputs(space):
    """A coarse plan and an interior residual on which every sum is exact in
    any order: small integers, eighths, and a part of 2^-25 on residuals of
    magnitude 1 to 3, below half of float32's step there.  The integer
    parts come in pairs (v, -v) that the first basis vector of each
    subdomain, and each aggregate, weighs alike, so they cancel there and
    the 2^-25 parts (signed as that basis vector) are all that is left.
    The float32 spectral path drops them where the JAX package casts the
    residual to the basis dtype; a path that kept them (a float64 basis,
    inverse or restriction) differs.  The aggregates path sums in float64
    and keeps them."""
    S, q, R = 4, 3, 24
    rng = np.random.default_rng(7)
    v = rng.choice([-3, -2, -1, 1, 2, 3], size=(S, R // 2))
    b0 = rng.choice([-2, -1, 1, 2], size=(S, R // 2))
    r = np.repeat(2.0 ** -25 * np.sign(b0), 2, axis=1)
    r[:, 0::2] += v
    r[:, 1::2] -= v
    plan = {"coarse_inv": (rng.integers(-16, 17, size=(S * q, S * q))
                           / 8.0).astype(np.float32)}
    if space == "spectral":
        basis = rng.integers(-2, 3, size=(S, q, R)).astype(np.float32)
        basis[:, 0] = np.repeat(b0, 2, axis=1)
        plan["coarse_basis"] = basis
    return plan, r


@pytest.mark.parametrize("space", ["spectral", "aggregates"])
def test_coarse_correct_casts_like_jax(space):
    """The coarse correction of the two-level step, bit for bit with the
    JAX package's: float32 basis and inverse as the plan stores them, the
    residual cast at the same point, a float64 result."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import schwarz_tpu.ras as jras
    from schwarz_tpu.parallel.mesh import SUBD_AXIS, make_mesh
    import torch

    from schwarz_tpu_torch.coarse_correction import coarse_correct

    plan, r = _exact_coarse_inputs(space)
    keys = sorted(plan)

    def f(r, *vals):
        return jras._coarse_correct(dict(zip(keys, vals)), r)

    mapped = jax.shard_map(f, mesh=make_mesh(jax.devices()[:1]),
                           in_specs=(P(SUBD_AXIS),) * (1 + len(keys)),
                           out_specs=P(SUBD_AXIS), check_vma=False)
    want = np.asarray(jax.jit(mapped)(jnp.asarray(r),
                                      *(jnp.asarray(plan[k]) for k in keys)))
    got = coarse_correct({k: torch.from_numpy(v) for k, v in plan.items()},
                         torch.from_numpy(r)).numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    if space == "spectral":
        # the residual's 2^-25 parts did not reach the float32 product
        assert np.array_equal(want, np.round(want * 8) / 8)
    else:
        assert np.abs(want).max() < 2.0 ** -15 and (want != 0).all()


@pytest.mark.parametrize("kw,match", [
    (dict(coarse_space="nope"), "coarse_space"),
    (dict(coarse_aggregates=7, row_pad_multiple=8), "coarse_aggregates"),
    (dict(coarse_solver="lu"), "coarse_solver"),
])
def test_coarse_settings_refused_like_jax(kw, match):
    A = tmodels.laplacian_2d(16)
    b = tmodels.generate_rhs(A.n)
    kw = dict(kw, two_level=True)
    with pytest.raises(ValueError, match=match):
        JSolver(jdecompose(A, b, jcfg.Settings(**kw), 4))
    with pytest.raises(ValueError, match=match):
        TSolver(tdecompose(A, b, tcfg.Settings(**kw), 4), device="cpu")


def test_coarse_cg_refuses_nonsymmetric():
    A = advection_diffusion_2d(12)
    At = tmodels.CSRMatrix.from_scipy(A.to_scipy())
    b = tmodels.generate_rhs(A.n)
    kw = dict(two_level=True, coarse_solver="cg", non_symmetric_matrix=True)
    with pytest.raises(ValueError, match="symmetric"):
        JSolver(jdecompose(A, b, jcfg.Settings(**kw), 4))
    with pytest.raises(ValueError, match="symmetric"):
        TSolver(tdecompose(At, b, tcfg.Settings(**kw), 4), device="cpu")


def test_host_coarse_sparse_branch(monkeypatch):
    """Above 2048 coarse unknowns HostCoarse factors A_c with a sparse LU,
    as the JAX package does: the same correction."""
    monkeypatch.delenv("SCHWARZ_TPU_COARSE_CACHE", raising=False)
    A = sp.csr_matrix(_operator(70))
    bnd = tco.equal_strip_boundaries(A.shape[0], 70)
    r = np.random.default_rng(5).standard_normal(A.shape[0])
    ct, cj = tco.HostCoarse(A, bnd, 30), jco.HostCoarse(A, bnd, 30)
    assert ct.A_c.shape == (2100, 2100) and sp.issparse(ct.A_c)
    np.testing.assert_array_equal(ct.solve(r), cj.solve(r))


def test_pooled_workers_run_the_ports_worker():
    """The pool runs this package's worker script by path (never the JAX
    package's): the same eigenspaces as the in-process path (the workers'
    one BLAS thread may round the last bits otherwise)."""
    import os

    A = _operator(20).tocsr()
    payloads = []
    for lo, hi in ((0, 200), (200, 400)):
        blk = A[lo:hi, lo:hi].tocsc()
        payloads.append((blk.data, blk.indices, blk.indptr, hi - lo, 4,
                         tco._EIGSH_TOL))
    pooled = tco._solve_blocks_subprocess(payloads, 2)
    assert pooled is not None
    for p, v in zip(payloads, pooled):
        w = tco._spectral_block_worker(p)
        # principal angles between the two spans: all cosines 1
        cos = np.linalg.svd(v.T @ w, compute_uv=False)
        np.testing.assert_allclose(cos, 1.0, atol=1e-9)
    worker = os.path.join(os.path.dirname(tco.__file__), "_spectral_worker.py")
    assert os.path.exists(worker) and "schwarz_tpu_torch" in worker
