"""Assembled FEM-style operators replacing the deal.II drivers (a numpy copy
of ``schwarz_tpu/models/fem.py``, bit-identical).

The reference's deal.II examples (benchmarking/dealii_ex_6.cpp adaptive FEM Poisson,
dealii_ex_9.cpp advection => GMRES path) exist to feed realistic symmetric and
non-symmetric operators into the Schwarz solver.  We generate the equivalent
assembled finite-difference operators directly:

  - :func:`anisotropic_diffusion_2d` — anisotropic Poisson like the bundled
    ani3/ani4 test matrices (matrices/ani3_crop.mtx): SPD, strong directional
    coupling, exercises the CG/Cholesky paths.
  - :func:`advection_diffusion_2d` — upwinded advection-diffusion: non-symmetric,
    exercises the GMRES path (cf. dealii_ex_9.cpp:508-511 using
    ``non_symmetric_matrix``).
"""

from __future__ import annotations

import numpy as np

from schwarz_tpu_torch.models.csr import CSRMatrix


def anisotropic_diffusion_2d(
    n: int, eps: float = 100.0, theta: float = 0.0, dtype=np.float64
) -> CSRMatrix:
    """Anisotropic diffusion ``-div(K grad u)`` on an n x n grid, SPD.

    ``K = R(theta) diag(1, eps) R(theta)^T`` discretized with a 9-point stencil so
    rotated anisotropy stays symmetric.  ``eps >> 1`` reproduces the strong
    directional coupling of the ani3/ani4 FEM matrices.
    """
    c, s = np.cos(theta), np.sin(theta)
    # K = R diag(1, eps) R^T
    kxx = c * c + eps * s * s
    kyy = s * s + eps * c * c
    kxy = (1.0 - eps) * c * s

    N = n * n
    i = np.arange(N, dtype=np.int64)
    x = i % n
    y = i // n

    # 9-point stencil: center, E, W, N, S, NE, NW, SE, SW
    # standard second-order FD for mixed derivatives
    entries = [
        (0, 0, 2.0 * (kxx + kyy)),
        (1, 0, -kxx),
        (-1, 0, -kxx),
        (0, 1, -kyy),
        (0, -1, -kyy),
        (1, 1, -0.5 * kxy),
        (-1, -1, -0.5 * kxy),
        (1, -1, 0.5 * kxy),
        (-1, 1, 0.5 * kxy),
    ]
    rows, cols, vals = [], [], []
    for dx, dy, v in entries:
        if v == 0.0:
            continue
        ok = (x + dx >= 0) & (x + dx < n) & (y + dy >= 0) & (y + dy < n)
        rows.append(i[ok])
        cols.append(i[ok] + dx + dy * n)
        vals.append(np.full(int(ok.sum()), v, dtype=dtype))
    return CSRMatrix.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), N
    )


def laplacian_3d(n: int, dtype=np.float64) -> CSRMatrix:
    """7-point Laplacian on an ``n^3`` grid — the 3-D scale-up of the
    reference's generated problem family (initialization.cpp:214-265 is 2-D)."""
    N = n * n * n
    i = np.arange(N, dtype=np.int64)
    x = i % n
    y = (i // n) % n
    z = i // (n * n)
    entries = [
        (0, 0, 0, 6.0),
        (1, 0, 0, -1.0), (-1, 0, 0, -1.0),
        (0, 1, 0, -1.0), (0, -1, 0, -1.0),
        (0, 0, 1, -1.0), (0, 0, -1, -1.0),
    ]
    rows, cols, vals = [], [], []
    for dx, dy, dz, v in entries:
        ok = (
            (x + dx >= 0) & (x + dx < n)
            & (y + dy >= 0) & (y + dy < n)
            & (z + dz >= 0) & (z + dz < n)
        )
        rows.append(i[ok])
        cols.append(i[ok] + dx + dy * n + dz * n * n)
        vals.append(np.full(int(ok.sum()), v, dtype=dtype))
    return CSRMatrix.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), N
    )


def helmholtz_2d(n: int, k: float = 5.0, dtype=np.float64) -> CSRMatrix:
    """Shifted Laplacian ``-lap(u) - k^2 u`` — indefinite for large ``k``;
    exercises the GMRES path beyond mild non-symmetry (symmetric indefinite)."""
    from schwarz_tpu_torch.models.laplacian import laplacian_2d

    A = laplacian_2d(n, dtype=dtype)
    h = 1.0 / (n + 1)
    shift = (k * h) ** 2
    # subtract k^2 h^2 from the diagonal (vectorized: O(nnz) numpy, not an
    # interpreted double loop — round-1 advisor finding)
    rows_of = np.repeat(np.arange(A.n, dtype=np.int64), np.diff(A.row_ptrs))
    A.values[A.col_idxs == rows_of] -= shift
    return A


def advection_diffusion_2d(
    n: int, peclet: float = 10.0, bx: float = 1.0, by: float = 0.5,
    dtype=np.float64, upwind: bool = True,
) -> CSRMatrix:
    """Advection-diffusion: ``-lap(u)/Pe + b . grad(u)`` — non-symmetric.

    ``upwind=True`` (default): first-order upwind advection keeps the matrix
    an M-matrix, so the GMRES local solver converges robustly (the reference
    solves the analogous dealii_ex_9 advection system with GMRES+restart,
    solve.cpp:486-570).  ``upwind=False``: second-order central differences —
    at high Peclet the operator becomes skew-dominant (strongly non-normal),
    the regime where short-recurrence methods (BiCGStab) stagnate and the
    optimal-in-the-Krylov-space GMRES is required.
    """
    N = n * n
    h = 1.0 / (n + 1)
    i = np.arange(N, dtype=np.int64)
    x = i % n
    y = i // n
    d = 1.0 / (peclet * h * h)

    if upwind:
        # diffusion part (5-point) + upwind advection
        ax_p = max(bx, 0.0) / h   # flow in +x: upwind uses west neighbor
        ax_m = max(-bx, 0.0) / h
        ay_p = max(by, 0.0) / h
        ay_m = max(-by, 0.0) / h

        entries = [
            (0, 0, 4.0 * d + ax_p + ax_m + ay_p + ay_m),
            (1, 0, -d - ax_m),
            (-1, 0, -d - ax_p),
            (0, 1, -d - ay_m),
            (0, -1, -d - ay_p),
        ]
    else:
        # central differences: b.grad(u) ~ b_x (u_E - u_W)/2h + ...
        entries = [
            (0, 0, 4.0 * d),
            (1, 0, -d + bx / (2 * h)),
            (-1, 0, -d - bx / (2 * h)),
            (0, 1, -d + by / (2 * h)),
            (0, -1, -d - by / (2 * h)),
        ]
    rows, cols, vals = [], [], []
    for dx, dy, v in entries:
        ok = (x + dx >= 0) & (x + dx < n) & (y + dy >= 0) & (y + dy < n)
        rows.append(i[ok])
        cols.append(i[ok] + dx + dy * n)
        vals.append(np.full(int(ok.sum()), v, dtype=dtype))
    return CSRMatrix.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), N
    )
