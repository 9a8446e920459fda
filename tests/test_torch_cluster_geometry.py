"""The launch geometry of the port's cluster kernels (K3, K5, K6, K9) and
K7's shared-memory sizing, on the CPU: the choice of blocks per unit from
what the card holds, the row and band splits, K3's and K7's shared-memory
sizes and variants, and the refusal of a cluster size the card cannot
hold.  The CUDA kernels themselves are held to
their plain versions in ``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from schwarz_tpu_torch.models import laplacian_2d
from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
from schwarz_tpu_torch.ops.async_ras_2d_kernel import (
    async_ras_2d_rounds, async_ras_2d_rounds_plain)
from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
from schwarz_tpu_torch.ops.async_ras_general_kernel import (
    async_general_rounds, async_general_rounds_plain)
from schwarz_tpu_torch.ops.cluster_geometry import (ANY_CLUSTER_SIZES,
                                                    CLUSTER_SIZES,
                                                    SMEM_PER_BLOCK,
                                                    SMEM_STATIC_RESERVE,
                                                    choose_cluster,
                                                    fused_cg_smem_bytes,
                                                    fused_cg_variant,
                                                    general_smem_bytes,
                                                    general_variant,
                                                    require_cluster,
                                                    split_rows)
from schwarz_tpu_torch.core.partition import partition_metis
from schwarz_tpu_torch.ops.fused_cg import (fused_cg_solve,
                                            fused_cg_solve_plain)

# clusters of C 1024-thread blocks an H100 80GB HBM3 holds at once, read
# from cudaOccupancyMaxActiveClusters for K3 and K6 (the same for both)
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("n,sizes,want", [
    (16, CLUSTER_SIZES, 4),
    (16, ANY_CLUSTER_SIZES, 6),
    (15, ANY_CLUSTER_SIZES, 8),
    (18, ANY_CLUSTER_SIZES, 5),
    (25, ANY_CLUSTER_SIZES, 4),
    (128, ANY_CLUSTER_SIZES, 1),
    (133, ANY_CLUSTER_SIZES, 0),
])
def test_choose_cluster_takes_the_largest_size_that_fits(n, sizes, want):
    assert choose_cluster(n, H100.__getitem__, sizes) == want


@pytest.mark.parametrize("C,need,raises", [
    (4, 16, False), (8, 16, True), (9, 1, True), (0, 1, True), (8, 1, False),
])
def test_require_cluster_raises_with_the_numbers(C, need, raises):
    fits = lambda c: H100.get(c, 0)   # noqa: E731
    if not raises:
        require_cluster("k", 16, C, fits, ANY_CLUSTER_SIZES, need, "rank")
        return
    with pytest.raises(RuntimeError, match="clusters") as e:
        require_cluster("k", 16, C, fits, ANY_CLUSTER_SIZES, need, "rank")
    assert f"clusters of {C} " in str(e.value)
    assert f"holds {H100.get(C, 0) if C in ANY_CLUSTER_SIZES else 0}" in str(
        e.value)


def test_require_cluster_refuses_a_size_outside_the_list():
    with pytest.raises(RuntimeError, match=r"sizes \(8, 4, 2, 1\)"):
        require_cluster("k", 4, 3, H100.__getitem__, CLUSTER_SIZES, 4, "rank")


@pytest.mark.parametrize("n", [1, 17, 128, 272, 1000, 71680, 71681])
@pytest.mark.parametrize("C", ANY_CLUSTER_SIZES)
@pytest.mark.parametrize("align", [1, 32])
def test_split_rows_owns_every_row_once(n, C, align):
    chunk, parts = split_rows(n, C, align)
    assert len(parts) == C and chunk % align == 0 and chunk * C >= n
    owner = np.zeros(n, np.int64)
    for r0, r1 in parts:
        assert 0 <= r0 <= r1 <= n
        owner[r0:r1] += 1
    assert (owner == 1).all()
    # contiguous, in block order
    assert all(parts[c][1] == parts[c + 1][0] for c in range(C - 1))


def test_k6_bands_of_the_2d_slice():
    """272 tile rows (the 2-D slice's 256-row blocks with their halos)."""
    assert split_rows(272, 4)[0] == 68
    band, parts = split_rows(272, 7)
    assert band == 39 and parts[-1] == (234, 272)


@pytest.mark.parametrize("C,precond,nbytes,variant", [
    (8, "jacobi", 8704 * 5 * 4, "shared"),
    (7, "jacobi", 9952 * 5 * 4, "shared"),
    (6, "jacobi", 11616 * 4 * 4, "shared"),    # dinv stays in device memory
    (5, "jacobi", 13952 * 4 * 4, "shared"),
    (4, "jacobi", 17408 * 4 * 4, "global"),
    (8, "none", 8704 * 4 * 4, "shared"),
    (1, "none", 69632 * 4 * 4, "global"),
])
def test_fused_cg_shared_memory_of_the_slice(C, precond, nbytes, variant):
    """69632 rows a subdomain (laplacian_2d(1024), 16 strips, overlap 3,
    rows padded to a multiple of 1024): the card holds 17 clusters of 6
    blocks, so the slice runs at C = 6 with x, r, p and A p in shared
    memory."""
    assert fused_cg_smem_bytes(69632, C, precond) == nbytes
    assert fused_cg_variant(69632, C, precond) == variant
    if variant == "shared":
        assert nbytes <= SMEM_PER_BLOCK


# the flagship's FSAI mode: 21504 rows a subdomain, A's 5 planes, G's 3 and
# G^T's 3; five vectors (x, r, p, A p, w) and, when they fit, the 11 planes
@pytest.mark.parametrize("C,nbytes,planes_in,variant", [
    (8, 2688 * (5 + 11) * 4, True, "shared"),
    (7, 3072 * (5 + 11) * 4, True, "shared"),
    (6, 3584 * (5 + 11) * 4, True, "shared"),    # 229376 of 230400 bytes
    (5, 4320 * 5 * 4, False, "shared"),          # the planes stream from L2
    (2, 10752 * 5 * 4, False, "shared"),
    (1, 21504 * 5 * 4, False, "global"),
])
def test_fused_cg_fsai_shared_memory_of_the_flagship(C, nbytes, planes_in,
                                                     variant):
    """The card holds 17 clusters of 6 blocks and 15 of 7 or 8, so the
    flagship's 16 subdomains run at C = 6 with the planes in shared
    memory."""
    cap = SMEM_PER_BLOCK - SMEM_STATIC_RESERVE
    assert fused_cg_smem_bytes(21504, C, "fsai", 11) == nbytes
    assert fused_cg_variant(21504, C, "fsai") == variant
    chunk = split_rows(21504, C, 32)[0]
    assert (chunk * (5 + 11) * 4 <= cap) == planes_in
    assert (nbytes <= cap) == (variant == "shared")
    assert choose_cluster(16, H100.__getitem__, ANY_CLUSTER_SIZES) == 6
    # FSAI keeps w where Jacobi keeps dinv: one vector more than 'none'
    assert fused_cg_smem_bytes(21504, C, "fsai") == chunk * 5 * 4


@pytest.mark.parametrize("planes,edge", [(0, 11520), (11, 3584)])
def test_fused_cg_fsai_planes_at_the_edge_of_shared_memory(planes, edge):
    """The largest chunk whose vectors (and planes) fit keeps them in
    shared memory; one 32-row step more falls back: the planes to L2, then
    the vectors to device memory."""
    cap = SMEM_PER_BLOCK - SMEM_STATIC_RESERVE
    full = lambda chunk: fused_cg_smem_bytes(chunk, 1, "fsai", planes)  # noqa
    assert full(edge) == edge * (5 + planes) * 4 <= cap
    assert full(edge + 32) == (edge + 32) * 5 * 4
    assert fused_cg_variant(edge, 1, "fsai") == (
        "shared" if edge * 5 * 4 <= cap else "global")
    if planes == 0:
        assert fused_cg_variant(edge + 32, 1, "fsai") == "global"


def test_cpu_wrappers_take_the_plain_versions_whatever_the_cluster():
    """On CPU tensors the wrappers take their plain versions; a forced
    cluster size does not change the result."""
    R, S = 256, 2
    offsets = (-16, -1, 0, 1, 16)
    rng = np.random.default_rng(0)
    dia = torch.zeros((S, 5, R))
    dia[:, 2] = 4.0
    for k in (0, 1, 3, 4):
        dia[:, k] = -0.5
    b = torch.tensor(rng.standard_normal((S, R)), dtype=torch.float32)
    args = (offsets, dia, b, torch.zeros_like(b), None, 1e-6, 50)
    got = fused_cg_solve(*args, cluster=8)
    ref = fused_cg_solve_plain(*args)
    assert torch.equal(got.x, ref.x) and torch.equal(got.iters, ref.iters)

    A = laplacian_2d(64)
    s = AsyncRASolver2D(A, np.ones(A.n), 2, 2, tolerance=1e-3, ninner=4,
                        chunk_rounds=2, device="cpu")
    X, known, aux = s.init_state()
    state = (s._fold(X), known, aux)
    got = s.launch(*state, fn=async_ras_2d_rounds, cluster=3)
    ref = s.launch(*state, fn=async_ras_2d_rounds_plain)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# K7's general slice: Rext = 2432 on the card's host, 2048 on another host
# (metis ties break differently), K = 9; 5 work vectors for CG, 8 for
# BiCGStab, 16-bit cols
@pytest.mark.parametrize("Rext,nonsym,nbytes", [
    (2432, False, 189696),   # 48 640 + 87 552 + 43 776 + 9 728
    (2432, True, 218880),
    (2048, False, 159744),
    (2048, True, 184320),
])
def test_general_shared_memory_of_the_slice(Rext, nonsym, nbytes):
    assert general_smem_bytes(Rext, 9, nonsym) == nbytes
    assert general_variant(Rext, 9, nonsym) == "shared"
    assert nbytes <= SMEM_PER_BLOCK - SMEM_STATIC_RESERVE


@pytest.mark.parametrize("K,nonsym,edge", [
    (9, False, 2953), (9, True, 2560), (5, False, 4266), (5, True, 3490),
])
def test_general_variant_at_the_edge_of_shared_memory(K, nonsym, edge):
    """The largest rank that fits takes 'shared', one row more 'global'."""
    cap = SMEM_PER_BLOCK - SMEM_STATIC_RESERVE
    assert general_smem_bytes(edge, K, nonsym) <= cap
    assert general_smem_bytes(edge + 1, K, nonsym) > cap
    assert general_variant(edge, K, nonsym) == "shared"
    assert general_variant(edge + 1, K, nonsym) == "global"


def test_general_cols_are_16_bit_up_to_65535_rows():
    # 5 vectors + vals + dinv at 4 bytes a row, cols 2 or 4 bytes (x16)
    assert general_smem_bytes(65535, 1, False) == 7 * 4 * 65535 + 131072
    assert general_smem_bytes(65536, 1, False) == 7 * 4 * 65536 + 4 * 65536
    assert general_variant(65536, 1, False) == "global"


def test_cpu_general_wrapper_takes_the_plain_version_whatever_is_forced():
    A = laplacian_2d(32)
    s = AsyncGeneralRASolver(A, np.ones(A.n), 4, overlap=2,
                             part=partition_metis(A, 4), chunk_rounds=2,
                             tolerance=1e-3, ninner=4, device="cpu")
    state = s.init_state()
    ref = s.launch(*state, fn=async_general_rounds_plain)
    for variant in ("global", "shared"):
        got = s.launch(*state, fn=lambda *a, **k: async_general_rounds(
            *a, **k, variant=variant))
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
