"""Optimized Schwarz tour: O-RAS Robin transmission conditions, Krylov
acceleration, and the indefinite-Helmholtz workflow.

    python -m schwarz_tpu_torch.examples.optimized_schwarz [--device cpu]

Three progressively harder configurations of the same machinery:

1. One-level RAS on a Poisson problem: classical against
   ``oras_weight="auto"`` (Robin transmission; typically 2-4x fewer outer
   iterations), then FSAI(0) against Jacobi under capped two-stage locals.
2. FGMRES acceleration (RAS as a preconditioner) on top of O-RAS.
3. Helmholtz: the stationary iteration diverges on indefinite problems; the
   FGMRES + O-RAS combination (Robin conditions double as approximate
   absorbing boundaries) converges.
"""

import numpy as np

from schwarz_tpu_torch import Settings, generate_rhs, laplacian_2d, solve
from schwarz_tpu_torch.config import LocalSolver, Precond
from schwarz_tpu_torch.models import helmholtz_2d

BASE = Settings(overlap=2, tolerance=1e-8, max_iters=400)
# the production configuration: inexact local solves with a hard iteration
# cap; a stronger approximate inverse buys outer iterations
CAPPED = BASE.replace(tolerance=1e-6, local_max_iters=6,
                      local_tolerance=1e-10)
HARD = Settings(overlap=3, tolerance=1e-8, max_iters=200,
                local_solver=LocalSolver.iterative_gmres)
# every solve of the tour: name, operator, grid size, settings, subdomains
SOLVES = [
    ("classical RAS", "laplacian_2d", 32, BASE, 8),
    ("O-RAS (auto)", "laplacian_2d", 32, BASE.replace(oras_weight="auto"), 8),
    ("FGMRES + O-RAS", "laplacian_2d", 32,
     BASE.replace(oras_weight="auto", accelerator="fgmres"), 8),
    ("capped, jacobi", "laplacian_2d", 32,
     CAPPED.replace(precond=Precond.jacobi), 8),
    ("capped, FSAI", "laplacian_2d", 32,
     CAPPED.replace(precond=Precond.fsai), 8),
    ("Helmholtz, stationary", "helmholtz_2d", 32,
     HARD.replace(max_iters=120), 4),
    ("Helmholtz, FGMRES + O-RAS", "helmholtz_2d", 32,
     HARD.replace(accelerator="fgmres", oras_weight=-0.5), 4),
]
OPERATORS = {"laplacian_2d": laplacian_2d, "helmholtz_2d": helmholtz_2d}


def true_res(A, b, r):
    return (np.linalg.norm(A.to_scipy() @ r.solution - np.asarray(b))
            / np.linalg.norm(np.asarray(b)))


def main(device=None):
    results = {}
    for name, op, n, settings, S in SOLVES:
        A = OPERATORS[op](n)
        b = generate_rhs(A.n)
        r = solve(A, b, settings, num_subdomains=S, device=device)
        results[name] = r
        print(f"{op} {n}^2, {S} subdomains, {name:26s}: "
              f"converged={r.converged} {r.iters:4d} iters, "
              f"true residual {true_res(A, b, r):.1e}")
    assert results["O-RAS (auto)"].iters < results["classical RAS"].iters
    assert results["Helmholtz, FGMRES + O-RAS"].converged
    return results


if __name__ == "__main__":
    from schwarz_tpu_torch.examples import device_from_args

    main(device_from_args(__doc__))
