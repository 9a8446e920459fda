"""Launch geometry of the kernels that run one unit of work (a rank of the
free-running tiers, a subdomain of the fused CG) on a thread-block cluster,
and the shared-memory sizing of those that keep a unit's data in one
block's shared memory (K3, K7).

A cluster is C thread blocks on C neighbouring SMs that share each other's
shared memory.  The card places a cluster inside one GPC, so how many
clusters of C blocks it holds at once is not 132 / C; the kernels' wrappers
ask the card (``cudaOccupancyMaxActiveClusters``) through a ``fits(C)``
probe and choose C here.  Everything in this module is plain Python, so the
CPU tests reach it.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

CLUSTER_SIZES = (8, 4, 2, 1)                   # K5's sizes, largest first
ANY_CLUSTER_SIZES = (8, 7, 6, 5, 4, 3, 2, 1)   # every portable size
SMEM_PER_BLOCK = 232448      # bytes of shared memory a block may have (H100)
SMEM_STATIC_RESERVE = 2048   # the kernels' static shared memory, rounded up
_SMEM_CAP = SMEM_PER_BLOCK - SMEM_STATIC_RESERVE


def choose_cluster(n_units: int, max_clusters: Callable[[int], int],
                   sizes: Sequence[int] = CLUSTER_SIZES) -> int:
    """Blocks per unit: the largest C of ``sizes`` for which the card holds
    ``n_units`` clusters of C blocks at once (``max_clusters(C)``), so that
    all units run in one wave; 0 when none does."""
    for c in sizes:
        if max_clusters(c) >= n_units:
            return c
    return 0


def require_cluster(what: str, n_units: int, C: int,
                    max_clusters: Callable[[int], int],
                    sizes: Sequence[int], need: int, unit: str) -> None:
    """Raise unless C is one of ``sizes`` and the card holds ``need``
    clusters of C blocks at once (``need`` is ``n_units`` for kernels whose
    units wait on each other, 1 for independent ones)."""
    have = max_clusters(C) if C in sizes else 0
    if have < need:
        raise RuntimeError(
            f"{what}: {n_units} {unit}s on clusters of {C} thread blocks "
            f"need {need} co-resident clusters; this card holds {have} "
            f"(sizes {tuple(sizes)})")


def split_rows(n_rows: int, C: int, align: int = 1) -> Tuple[int, list]:
    """Contiguous shares of ``n_rows`` over C blocks: the chunk length
    (ceil(n_rows / C) rounded up to ``align``) and each block's [r0, r1).
    Every row is owned once; trailing blocks may own fewer rows, or none."""
    chunk = -(-(-(-n_rows // C)) // align) * align
    return chunk, [(min(n_rows, c * chunk), min(n_rows, (c + 1) * chunk))
                   for c in range(C)]


def fused_cg_smem_bytes(n_rows: int, C: int, precond: str = "none",
                        planes: int = 0) -> int:
    """Dynamic shared memory of a block of K3's shared-memory variant: its
    chunk of x, r, p and A p, float32.  Under ``precond`` 'jacobi' the
    chunk of dinv too, when that still fits (else dinv is read from device
    memory).  Under 'fsai' the chunk of w = G r as a fifth vector, and the
    chunk of the ``planes`` diagonal planes of A, G and G^T when those
    still fit (else they stream from L2)."""
    chunk, _ = split_rows(n_rows, C, 32)
    four, five = chunk * 4 * 4, chunk * 5 * 4
    if precond == "fsai":
        full = five + planes * chunk * 4
        return full if full <= _SMEM_CAP else five
    return five if precond == "jacobi" and five <= _SMEM_CAP else four


def fused_cg_variant(n_rows: int, C: int, precond: str = "none") -> str:
    """'shared' when a block's chunk of K3's work vectors (x, r, p, A p;
    FSAI's w too) fits its shared memory, else 'global' (the same kernel
    with the vectors in device memory)."""
    fits = fused_cg_smem_bytes(n_rows, C, precond) <= _SMEM_CAP
    return "shared" if fits else "global"


def general_smem_bytes(Rext: int, K: int, nonsym: bool) -> int:
    """Dynamic shared memory of a block of K7's shared-memory variant, in
    the order the kernel places them: the rank's work vectors (xe, r, p, z,
    A p; BiCGStab's three more) float32, then the ELL planes, ``vals``
    float32 and ``cols`` as 16-bit indices when Rext <= 65535 (else 32-bit),
    padded to 16 bytes, then dinv (``SmemLayout`` in
    ``csrc/async_ras_general.cu``)."""
    vectors = (8 if nonsym else 5) * Rext * 4
    vals = K * Rext * 4
    cols = -(-K * Rext * (2 if Rext <= 65535 else 4) // 16) * 16
    return vectors + vals + cols + Rext * 4


def general_variant(Rext: int, K: int, nonsym: bool) -> str:
    """'shared' when a rank's whole working set fits one block's shared
    memory (:func:`general_smem_bytes`), else 'global' (the same kernel with
    every array in device memory)."""
    fits = general_smem_bytes(Rext, K, nonsym) <= _SMEM_CAP
    return "shared" if fits else "global"
