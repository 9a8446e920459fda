"""Worker for the port's solve across processes: one process of a gloo
group (the counterpart of ``tests/distributed_worker.py``; PyTorch only, no
JAX), and :func:`run_group`, which starts a group of them.

    python tests/torch_mesh_worker.py <out_dir> <device> <pid> <nproc> <port>

Each process joins the group at ``localhost:<port>``, builds a mesh of 8
ranks (``nproc`` processes of 8 / nproc ranks), runs the mesh primitives
and the solves of ``CASES`` with every process's inputs made the same way,
and writes what it saw to ``<out_dir>/p<pid>.npz``; ``tests/
test_torch_mesh.py`` compares the processes with each other, with the
port's single-process solve and with the JAX package.  Prints
``WORKER_OK`` last.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from schwarz_tpu_torch import (CommSettings, ConvergenceSettings,  # noqa: E402
                               GlobalConvergence, HaloStrategy, Precond,
                               Settings, generate_rhs, laplacian_2d, solve)
from schwarz_tpu_torch.core.decompose import decompose  # noqa: E402
from schwarz_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from schwarz_tpu_torch.ras import RASolver  # noqa: E402

D = 8
NB = dict(comm=CommSettings(strategy=HaloStrategy.neighbor))
TWO = dict(two_level=True, coarse_aggregates=2, coarse_space="spectral")


def conv(method):
    return dict(convergence=ConvergenceSettings(
        method=GlobalConvergence(method)))


# float32 local solves through K3 (its plain version on the CPU)
FUSED = dict(NB, local_compute_dtype="float32", spmv_format="dia",
             row_pad_multiple=128, fused_local_cg=True,
             precond=Precond.jacobi, local_tolerance=1e-6)
# the solves each group size runs: name -> Settings fields beyond BASE
CASES = {
    2: {"neighbor": NB, "all_gather": {}, "two_level_cg":
        dict(NB, coarse_solver="cg", **TWO), "two_level_dense": TWO,
        "fgmres": dict(accelerator="fgmres"), "fused_cg": FUSED},
    4: {"neighbor": NB, "tree": conv("tree"),
        "decentralized": conv("decentralized"),
        "allreduce": conv("allreduce")},
}
# the histories' rtol against another package or device where it is not
# 1e-8: float32 locals add in another order (twice the reading against the
# JAX package, 2.0e-6)
RTOL = {"fused_cg": 4e-6}
# tests/distributed_worker.py's configuration at tolerance 1e-6
BASE = dict(overlap=3, tolerance=1e-6, max_iters=300, dtype="float64")
# free-running's tolerance: at or above the float32 kernels' in-band floor
FREE_TOL = 1e-4


def primitives(mesh, out, pid, device):
    """all_gather, psum, process_allgather and every shift of a global
    (D, 3) array, each process holding its block."""
    G = torch.arange(D * 3, dtype=torch.float64, device=device).reshape(D, 3)
    mine = G[mesh.block(D)]
    out["all_gather"] = mesh.all_gather(mine).cpu().numpy()
    out["process_allgather"] = mesh.process_allgather(mine + 1)
    out["psum"] = mesh.psum(torch.tensor(float(pid + 1), dtype=torch.float64,
                                         device=device)).cpu().numpy()
    for r in range(-D - 1, D + 2):
        out[f"shift_{r}"] = mesh.shift(mine, r).cpu().numpy()
    out["bf16"] = mesh.all_gather(mine.to(torch.bfloat16)).float().cpu(
    ).numpy()


def main(pid: int, nproc: int, port: str, out_dir: str, device: str):
    pmesh.initialize(f"localhost:{port}", nproc, pid, timeout_s=120)
    mesh = pmesh.make_mesh(num_ranks=D, device=device)
    out = {}
    primitives(mesh, out, pid, device)
    A = laplacian_2d(16)
    b = generate_rhs(A.n, random=False)
    for name, kw in CASES[nproc].items():
        r = solve(A, b, Settings(**BASE, **kw), mesh=mesh)
        out[f"{name}.iters"] = r.iters
        out[f"{name}.converged"] = r.converged
        out[f"{name}.rel"] = r.relative_residual_norm
        out[f"{name}.global"] = r.global_resnorm_history
        out[f"{name}.local"] = r.local_resnorm_history
        out[f"{name}.inner"] = r.inner_iters_history
        out[f"{name}.solution"] = r.solution
    # the plan and the locality on this mesh
    nb = RASolver(decompose(A, b, Settings(**BASE, **NB), D), mesh=mesh)
    out["round_is_dcn"] = np.asarray(nb._neighbor_plan.round_is_dcn)
    out["offsets"] = np.asarray(nb._neighbor_plan.offsets)
    out["locality"] = nb.neighbor_locality()
    out["comm_calls"] = mesh.stats["calls"]
    if nproc == 2:
        multi_process_paths(A, b, mesh, nb, out, out_dir)
    np.savez(os.path.join(out_dir, f"p{pid}.npz"), **out)
    pmesh.shutdown()
    print("WORKER_OK", flush=True)


def multi_process_paths(A, b, mesh, nb, out, out_dir):
    """The JAX package's multi-process paths: the one-sided exchange (K4's
    plain version through Mesh.shift), free-running (at the in-band
    tolerance FREE_TOL, no refinement restarts), the checkpoints."""
    rd = Settings(**BASE, comm=CommSettings(strategy=HaloStrategy.rdma))
    out["ok.rdma"] = solve(A, b, rd, mesh=mesh).global_resnorm_history
    fr = solve(A, b, Settings(**{**BASE, "tolerance": FREE_TOL},
                              free_running=True), mesh=mesh)
    out["ok.free_running"] = fr.solution
    out["ok.free_running_converged"] = fr.converged
    ckpt = os.path.join(out_dir, "c.npz")
    out["ok.checkpoint"] = nb.run(
        checkpoint_path=ckpt).global_resnorm_history
    st = nb.load_checkpoint(ckpt)
    out["ok.load"] = st["x_own"].cpu().numpy()
    out["ok.resume"] = nb.run(resume_state=st).iters
    fg = RASolver(decompose(A, b, Settings(**BASE, accelerator="fgmres"), D),
                  mesh=mesh)
    fpath = os.path.join(out_dir, "f.npz")
    out["ok.fgmres_checkpoint"] = fg.run_accelerated(
        checkpoint_path=fpath).iters
    out["ok.fgmres_load"] = fg.load_accel_checkpoint(fpath)[0].cpu().numpy()


def run_group(nproc: int, out_dir: str, device: str = "cpu",
              timeout_s: float = 240) -> list:
    """Run the worker in ``nproc`` processes; their outputs, in process
    order.  Raises when a worker fails or outlasts ``timeout_s``, after
    killing every one still running (``mesh.launch``)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    logs = pmesh.launch(
        [sys.executable, os.path.abspath(__file__), out_dir, device], nproc,
        out_dir, timeout_s, env=env)
    for pid, log in enumerate(logs):
        if "WORKER_OK" not in log:
            raise RuntimeError(f"worker {pid} did not finish:\n{log[-4000:]}")
    res = []
    for pid in range(nproc):
        with np.load(os.path.join(out_dir, f"p{pid}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


if __name__ == "__main__":
    main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[1],
         sys.argv[2])
