"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.  They
import neither JAX nor the JAX package, so on a machine without JAX run them
without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv, dia_spmv_plain
from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve, fused_cg_solve_plain
from schwarz_tpu_torch.ops.halo_kernel import assemble_runs, assemble_runs_plain

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_runs_bit_identical(dev, dtype):
    rng = np.random.default_rng(1)
    S, r_ext, ldb, n_all = 4, 900, 1000, 4 * 700
    lens = np.array([1, 7, 130, 333], np.int32)
    src = rng.integers(0, n_all - 333, (S, 4)).astype(np.int32)
    dst = np.stack([[0, 11, 300, 500]] * S).astype(np.int32)
    dst[2, 1] = r_ext                      # unused entry
    x_all = torch.tensor(rng.standard_normal(n_all), dtype=dtype, device=dev)
    buf = torch.tensor(rng.standard_normal((S, ldb)), dtype=dtype,
                       device=dev)
    ref = buf.clone()
    tables = [torch.tensor(t, device=dev) for t in (src, dst, lens)]
    assemble_runs(buf, x_all, *tables, r_ext)
    torch.cuda.synchronize()
    assemble_runs_plain(ref, x_all, *tables, r_ext)
    assert torch.equal(buf, ref)


@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_cg_matches_plain(dev, jacobi):
    S, R, n1d = 4, 1024, 32
    offsets = (-n1d, -1, 0, 1, n1d)
    r = np.arange(R)
    dia = np.zeros((S, 5, R))
    dia[:, 2] = 4.0 + np.arange(S)[:, None] * 0.5
    for k, o in enumerate(offsets):
        if o:
            ok = (r + o >= 0) & (r + o < R)
            if abs(o) == 1:
                ok &= (r // n1d) == ((r + o) // n1d)
            dia[:, k, ok] = -1.0
    rng = np.random.default_rng(2)
    b = rng.standard_normal((S, R))
    b[3] = 0.0                             # a subdomain that never iterates
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    dinv = t(1.0 / dia[:, 2]) if jacobi else None
    args = (offsets, t(dia), t(b), t(np.zeros((S, R))), dinv, 1e-5, 200)
    got = fused_cg_solve(*args)
    torch.cuda.synchronize()
    ref = fused_cg_solve_plain(*args)
    assert int(got.iters[3]) == 0
    assert (got.iters - ref.iters).abs().max().item() <= 1
    torch.testing.assert_close(got.x, ref.x, rtol=0, atol=5e-4)
