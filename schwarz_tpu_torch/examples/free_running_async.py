"""Free-running asynchronous RAS: the reference's research configuration
(restricted_schwarz.cpp:714-852) as one multi-iteration kernel launch.

    python -m schwarz_tpu_torch.examples.free_running_async [--device cpu]

Ranks iterate at independent rates: the only coupling between them is a
bounded-staleness wait on per-neighbour one-sided rings in device memory,
and convergence is detected by decentralized gossip carried inside the
halo messages.
"""

import numpy as np

from schwarz_tpu_torch import AsyncRASolver, generate_rhs, laplacian_2d
from schwarz_tpu_torch.models.fem import advection_diffusion_2d


def main(device=None):
    out = {}
    A = laplacian_2d(24)                 # 576-row 2-D Poisson
    b = generate_rhs(A.n, random=False)
    solver = AsyncRASolver(
        A, b,
        num_subdomains=4,                # one rank each
        overlap=2,                       # effective overlap is padded up
        tolerance=1e-5,
        staleness=2,                     # halo age bound B (iterations)
        ninner=20,                       # inexact (two-stage) local CG
        chunk_rounds=10,                 # barrier-free rounds per launch
        device=device,
    )
    x, info = out["plain"] = solver.run(max_rounds=300)
    print(f"converged:              {info['converged']}")
    print(f"per-rank detection:     {info['done_at'].tolist()}  <- each "
          "rank learned of global convergence at its own iteration")
    print(f"rounds executed:        {info['rounds']}")
    print(f"true relative residual: {info['relative_residual_norm']:.3e}")
    print(f"effective overlap:      {info['effective_overlap']}")
    x_ref = np.linalg.solve(A.to_scipy().toarray(), b)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    print(f"error vs direct solve:  {err:.3e}")

    # --- below the f32 floor: iterative-refinement restarts ---------------
    # The f32 kernel cannot detect relative tolerances below ~1e-5 in-band.
    # run_refined() reuses the same kernel: it solves correction equations
    # A dx = r at the solver's moderate tolerance, recomputes the true
    # residual in f64 between launches, and repacks only the rhs.
    x64, rinfo = out["refined"] = solver.run_refined(tol=1e-12,
                                                     max_rounds=300)
    err64 = np.linalg.norm(x64 - x_ref) / np.linalg.norm(x_ref)
    print(f"refined ({rinfo['restarts']} restarts): "
          f"true residual {rinfo['relative_residual_norm']:.3e}, "
          f"error vs direct {err64:.3e}")

    # --- O-RAS Robin transmission inside the kernel -------------------------
    # The correction solves run on A_dom + c*D_drop while the residual keeps
    # the true A: the same fixed point, fewer detection rounds; the gain is
    # largest when the overlap is thin.
    kw = dict(num_subdomains=4, overlap=1, tolerance=1e-5, staleness=2,
              ninner=20, chunk_rounds=10, device=device)
    _, oinfo = out["oras"] = AsyncRASolver(
        A, b, oras_weight=-0.8, **kw).run(max_rounds=300)
    _, cinfo = out["classical"] = AsyncRASolver(A, b, **kw).run(
        max_rounds=300)
    print(f"thin-overlap rounds:    classical {cinfo['rounds']} vs "
          f"O-RAS {oinfo['rounds']}")

    # --- non-symmetric operators: in-kernel Jacobi-BiCGStab -----------------
    An = advection_diffusion_2d(24)
    bn = generate_rhs(An.n, random=False)
    nonsym = AsyncRASolver(An, bn, num_subdomains=4, overlap=2,
                           tolerance=1e-4, staleness=1, ninner=10,
                           chunk_rounds=8, nonsym=True, device=device)
    _, ninfo = out["nonsym"] = nonsym.run(max_rounds=400)
    print(f"advection (BiCGStab):   converged={ninfo['converged']}, "
          f"true residual {ninfo['relative_residual_norm']:.3e}")
    return out


if __name__ == "__main__":
    from schwarz_tpu_torch.examples import device_from_args

    main(device_from_args(__doc__))
