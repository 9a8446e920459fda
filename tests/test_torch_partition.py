"""The port's regular 2-D and METIS-equivalent partitioners against the JAX
package's, on the CPU: the partitions, the decompositions built on them and
the synchronous solve must agree.  The partitioners are deterministic numpy
and ``heapq`` loops (the JAX package's native kernels are bit-identical to
its own loops), so every comparison of a partition is exact."""

import dataclasses
import importlib

import numpy as np
import pytest

import schwarz_tpu.config as jcfg
import schwarz_tpu.core.partition as jpart
import schwarz_tpu.models as jmodels
from schwarz_tpu.ras import solve as jsolve
import schwarz_tpu_torch
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.core.partition as tpart
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.ras import solve as tsolve

jdec = importlib.import_module("schwarz_tpu.core.decompose")
tdec = importlib.import_module("schwarz_tpu_torch.core.decompose")

ARRAYS = ("perm", "iperm", "first_row", "interior_count", "interior_offset",
          "rows_count", "ghost_count", "local_to_global", "lmat_cols",
          "lmat_vals", "imat_cols", "imat_vals", "iface_rows", "iface_cols",
          "iface_vals", "local_rhs", "halo_src", "halo_slots",
          "halo_src_halo", "comm_matrix", "global_rhs")

# (matrix, parts): below and above the 400-vertex switch to the multilevel
# bisection, even and uneven recursion, grid and unstructured graphs
METIS_CASES = [("lap12", 4), ("lap16", 8), ("lap24", 4), ("lap24", 3),
               ("ani3", 4), ("ani4", 8)]


def _matrix(kind, models):
    if kind.startswith("lap"):
        return models.laplacian_2d(int(kind[3:]))
    return models.read_mtx(models.matrix_path(f"{kind}_crop.mtx"))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["counts", "cell_weights"])
@pytest.mark.parametrize("kind,S", METIS_CASES,
                         ids=[f"{k}-{s}" for k, s in METIS_CASES])
def test_partition_metis_identical(kind, S, weighted):
    A, B = _matrix(kind, jmodels), _matrix(kind, tmodels)
    w = (np.random.default_rng(5).integers(1, 6, A.n) if weighted else None)
    pj = jpart.partition_metis(A, S, cell_weights=w)
    pt = tpart.partition_metis(B, S, cell_weights=w)
    assert pt.dtype == pj.dtype
    np.testing.assert_array_equal(pt, pj)
    assert np.bincount(pt, minlength=S).min() > 0


@pytest.mark.parametrize("n,S", [(144, 4), (256, 16), (36, 9), (64, 1)])
def test_partition_regular_2d_identical(n, S):
    pj, pt = jpart.partition_regular_2d(n, S), tpart.partition_regular_2d(n, S)
    assert pt.dtype == pj.dtype
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("n,S", [(150, 4), (144, 8), (144, 25)])
def test_partition_regular_2d_gates(n, S):
    for mod in (jpart, tpart):
        with pytest.raises(ValueError, match="regular2d needs"):
            mod.partition_regular_2d(n, S)


@pytest.mark.parametrize("part,S,weighted", [
    ("regular2d", 4, False), ("metis", 4, False), ("metis", 3, True),
    ("metis", 1, False),
])
def test_make_partition_identical(part, S, weighted):
    A, B = jmodels.laplacian_2d(12), tmodels.laplacian_2d(12)
    w = np.arange(A.n) % 4 + 1 if weighted else None
    pj = jpart.make_partition(A, S, jcfg.Settings(partition=jcfg.Partition(part)),
                              cell_weights=w)
    pt = tpart.make_partition(B, S, tcfg.Settings(partition=tcfg.Partition(part)),
                              cell_weights=w)
    np.testing.assert_array_equal(pt, pj)


def test_make_partition_gates():
    B = tmodels.laplacian_2d(12)
    w = np.ones(B.n)
    with pytest.raises(ValueError, match="fixed squares"):
        tpart.make_partition(
            B, 4, tcfg.Settings(partition=tcfg.Partition.regular2d), w)
    with pytest.raises(ValueError, match="one weight per"):
        tpart.make_partition(
            B, 4, tcfg.Settings(partition=tcfg.Partition.metis), w[:-1])
    with pytest.raises(ValueError, match="non-negative"):
        tpart.make_partition(
            B, 4, tcfg.Settings(partition=tcfg.Partition.metis), -w)


def test_package_exports_partitioners():
    assert schwarz_tpu_torch.partition_metis is tpart.partition_metis
    assert schwarz_tpu_torch.partition_regular_2d is tpart.partition_regular_2d


@pytest.mark.parametrize("kind,part,S,overlap,weighted", [
    ("lap12", "metis", 4, 2, False),
    ("lap16", "regular2d", 4, 3, False),
    ("lap16", "regular2d", 16, 1, False),
    ("ani3", "metis", 4, 2, False),
    ("lap24", "metis", 3, 2, True),
])
def test_decomposition_on_partition_bit_identical(kind, part, S, overlap,
                                                  weighted):
    decs = []
    for models, cfg, dec in ((jmodels, jcfg, jdec), (tmodels, tcfg, tdec)):
        A = _matrix(kind, models)
        w = (np.random.default_rng(3).integers(1, 4, A.n) if weighted
             else None)
        s = cfg.Settings(partition=cfg.Partition(part), overlap=overlap)
        decs.append(dec.decompose(A, models.generate_rhs(A.n), s, S,
                                  cell_weights=w))
    dj, dt = decs
    assert dataclasses.asdict(dj.meta) == dataclasses.asdict(dt.meta)
    for name in ARRAYS:
        a, b = getattr(dj, name), getattr(dt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for mj, mt in zip(dj.masks(), dt.masks()):
        np.testing.assert_array_equal(mj, mt)


@pytest.mark.parametrize("part", ["metis", "regular2d"])
def test_synchronous_solve_on_partition_matches(part):
    """Default Settings (float64) on a metis or regular 2-D partition: equal
    iteration counts and histories within 1e-8 (sums in another order)."""
    A, B = jmodels.laplacian_2d(12), tmodels.laplacian_2d(12)
    b = jmodels.generate_rhs(A.n)
    rj = jsolve(A, b, jcfg.Settings(partition=jcfg.Partition(part)), 4)
    rt = tsolve(B, b, tcfg.Settings(partition=tcfg.Partition(part)), 4,
                device="cpu")
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=1e-8)
    np.testing.assert_allclose(
        rt.local_resnorm_history, rj.local_resnorm_history, rtol=1e-8,
        atol=1e-8 * np.abs(rj.local_resnorm_history).max())
    np.testing.assert_allclose(rt.solution, rj.solution, rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_array_equal(rt.comm_matrix, rj.comm_matrix)
