"""Advanced configuration tour: METIS partitioning, GMRES locals,
asynchronous (stale-halo) iteration with decentralized convergence
detection, neighbour halo transport, mixed-precision halos, and
checkpointing.

    python -m schwarz_tpu_torch.examples.advanced_async [--device cpu]
"""

import os
import tempfile

from schwarz_tpu_torch import (CommSettings, ConvergenceSettings,
                               GlobalConvergence, HaloStrategy, LocalSolver,
                               Partition, Settings, advection_diffusion_2d,
                               generate_rhs)
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.ras import RASolver

SETTINGS = Settings(
    partition=Partition.metis,
    overlap=3,
    local_solver=LocalSolver.iterative_gmres,
    non_symmetric_matrix=True,
    restart_iter=30,
    # mixed-precision halos floor the attainable local residual around
    # ~3e-6 (received values carry float32 rounding); pick the tolerance
    # accordingly
    tolerance=1e-5,
    max_iters=500,
    halo_dtype="float32",                # mixed-precision halos under f64
    comm=CommSettings(
        onesided=True,                   # asynchronous (stale-halo) iteration
        staleness=2,
        strategy=HaloStrategy.neighbor,  # packed neighbour rounds
    ),
    convergence=ConvergenceSettings(
        method=GlobalConvergence.decentralized,
    ),
)


def main(device=None):
    A = advection_diffusion_2d(48)       # non-symmetric operator
    b = generate_rhs(A.n)
    dec = decompose(A, b, SETTINGS, num_subdomains=4)
    solver = RASolver(dec, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        result = solver.run(checkpoint_path=ckpt)
        print(f"converged={result.converged} iters={result.iters} "
              f"rel={result.relative_residual_norm:.3e}")
        # resume from the checkpoint (e.g. to continue with a larger budget)
        state = solver.load_checkpoint(ckpt)
    again = solver.run(resume_state=state)
    print(f"resumed from iteration {int(state['it'])}: "
          f"converged={again.converged} iters={again.iters}")
    return result, again


if __name__ == "__main__":
    from schwarz_tpu_torch.examples import device_from_args

    main(device_from_args(__doc__))
