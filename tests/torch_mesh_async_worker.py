"""Worker for the port's one-sided exchange, free-running solvers and
checkpoints across processes: one process of a gloo group (PyTorch only, no
JAX), and :func:`run_group`, which starts a group of them.

    python tests/torch_mesh_async_worker.py <out_dir> <device> <groups> \\
        <pid> <nproc> <port>

``groups`` is a comma-separated subset of :data:`GROUPS`.  Each process
joins the group at ``localhost:<port>``, runs the cases of those groups
with every process's inputs made the same way, and writes what it saw to
``<out_dir>/p<pid>.npz``; ``tests/test_torch_mesh_async.py`` (CPU) and
``tests/test_torch_cuda.py`` (card) compare the processes with each other,
with the port in one process and with the JAX package.  A checkpoint that
a case resumes from a file written in one process is read from
``<out_dir>/single.npz`` when that file exists.  Prints ``WORKER_OK``
last.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from schwarz_tpu_torch import (AsyncGeneralRASolver,  # noqa: E402
                               AsyncRASolver, AsyncRASolver2D, CommSettings,
                               HaloStrategy, Settings, generate_rhs,
                               laplacian_2d, partition_metis, solve)
from schwarz_tpu_torch.core.decompose import decompose  # noqa: E402
from schwarz_tpu_torch.ops import rdma_kernel as rk  # noqa: E402
from schwarz_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from schwarz_tpu_torch.parallel.neighbor_exchange import (  # noqa: E402
    build_neighbor_plan, exchange_rounds)
from schwarz_tpu_torch.ras import RASolver  # noqa: E402

D = 8
# tests/torch_mesh_worker.py's configuration (laplacian_2d(16), overlap 3,
# float64, tolerance 1e-6, 8 ranks)
BASE = dict(overlap=3, tolerance=1e-6, max_iters=300, dtype="float64")
# the one-sided strategy's variants: put, get, one-by-one, flush-local
PUT = dict(enable_put=True, enable_get=False)
RDMA = {
    "put": PUT,
    "get": dict(),
    "one_by_one": dict(PUT, enable_one_by_one=True),
    "flush_local": dict(enable_one_by_one=True, flush_type="flush-local"),
}
# the free-running configurations of the single-process test files:
# tests/test_torch_async_ras.py CASES["D4-B1"] (two launches of 8 rounds),
# tests/test_torch_async2d_ras.py CASES["D4"] (20 rounds of 4),
# tests/test_torch_general_ras.py CASES["metis4"] (to convergence)
FREE_1D = dict(overlap=2, chunk_rounds=8, staleness=1, tolerance=1e-2,
               ninner=8)
FREE_1D_ROUNDS = 16
FREE_2D = dict(px=2, py=2, chunk_rounds=4, tolerance=1e-3, ninner=8)
FREE_2D_ROUNDS = 20
FREE_GEN = dict(overlap=2, chunk_rounds=4, tolerance=1e-3, ninner=8)
FREE_GEN_ROUNDS = 400
# iterations of the synchronous checkpoints' first half
HALF = 9
GROUPS = ("rdma", "k4", "free", "ckpt")


def problem():
    A = laplacian_2d(16)
    return A, generate_rhs(A.n, random=False)


def rdma_settings(variant, **kw):
    return Settings(**{**BASE, **kw}, comm=CommSettings(
        strategy=HaloStrategy.rdma, **RDMA[variant]))


def free_1d(mesh, device, **kw):
    A = laplacian_2d(16)
    b = generate_rhs(A.n, random=False)
    return AsyncRASolver(A, b, 4, device=device, mesh=mesh,
                         **{**FREE_1D, **kw})


def free_2d(mesh, device):
    A = laplacian_2d(16)
    b = np.random.default_rng(11).uniform(0.5, 1.5, A.n)
    return AsyncRASolver2D(A, b, device=device, mesh=mesh, **FREE_2D)


def free_general(mesh, device):
    A = laplacian_2d(12)
    return AsyncGeneralRASolver(A, np.ones(A.n), 4, part=partition_metis(A, 4),
                                device=device, mesh=mesh, **FREE_GEN)


def record(out, name, r):
    out[f"{name}.iters"] = r.iters
    out[f"{name}.converged"] = r.converged
    out[f"{name}.global"] = r.global_resnorm_history
    out[f"{name}.local"] = r.local_resnorm_history
    out[f"{name}.inner"] = r.inner_iters_history
    out[f"{name}.solution"] = r.solution


def record_free(out, name, x, info):
    out[f"{name}.x"] = x
    for k in ("done_at", "rounds", "total_rounds", "converged"):
        if k in info:
            out[f"{name}.{k}"] = info[k]


def case_rdma(mesh, out, device):
    A, b = problem()
    for v in RDMA:
        record(out, f"rdma_{v}", solve(A, b, rdma_settings(v), mesh=mesh))
    # the two-sided strategy, which moves the same values
    nb = Settings(**BASE, comm=CommSettings(strategy=HaloStrategy.neighbor))
    record(out, "neighbor", solve(A, b, nb, mesh=mesh))


def case_k4(mesh, out, device):
    """K4's exchange across processes against its plain version with
    ``Mesh.shift``, every variant, in launches that carry one set of
    sequence words."""
    A, b = problem()
    dec = decompose(A, b, Settings(**BASE), D)
    nx = build_neighbor_plan(dec, D, process_of=mesh.process_of)
    rounds = exchange_rounds(nx, device, mesh)
    S, r_int = dec.meta.num_subdomains, dec.meta.max_interior
    rng = np.random.default_rng(5)
    g = rng.standard_normal((S, r_int))
    for i, (mode, obo, fl) in enumerate(
            [("put", False, False), ("get", False, False),
             ("put", True, False), ("get", True, True),
             ("put", False, False)]):
        x = torch.tensor(g[mesh.block(S)] + i, device=device)
        halo, status = rk.rdma_exchange_launch(x, rounds, None, mode, obo,
                                               fl)
        counts = rk.rdma_shift_finish([status])[0]
        ref = rk.exchange_rounds_plain(x, rounds, None, mesh.shift)
        out[f"k4_{i}.equal"] = bool(torch.equal(halo, ref))
        out[f"k4_{i}.counts"] = counts.cpu().numpy()
    if rounds._card is not None:
        out["k4.longest_wait_ns"] = rounds._card.longest_wait_ns()


def case_free(mesh, device):
    out = {}
    record_free(out, "free_1d",
                *free_1d(mesh, device).run(max_rounds=FREE_1D_ROUNDS))
    record_free(out, "free_2d",
                *free_2d(mesh, device).run(max_rounds=FREE_2D_ROUNDS))
    record_free(out, "free_general",
                *free_general(mesh, device).run(max_rounds=FREE_GEN_ROUNDS))
    s = free_1d(mesh, device, tolerance=1e-4, ninner=20, chunk_rounds=16)
    x, info = s.run_refined(tol=1e-8, max_rounds=400)
    out["refined.x"] = x
    out["refined.rel"] = info["relative_residual_norm"]
    out["refined.restarts"] = info["restarts"]
    return out


def case_ckpt(mesh, out, device, out_dir):
    A, b = problem()
    pid = mesh.process_index
    # the synchronous solve: a straight run, and one stopped at HALF
    # iterations with a checkpoint, resumed across the processes
    full = RASolver(decompose(A, b, Settings(**BASE), D), mesh=mesh)
    record(out, "ck_straight", full.run())
    half = RASolver(decompose(A, b, Settings(**{**BASE, "max_iters": HALF}),
                              D), mesh=mesh)
    path = os.path.join(out_dir, "half.npz")
    r = half.run(checkpoint_path=path)
    out["ck_half.iters"] = r.iters
    st = full.load_checkpoint(path)
    out["ck_block"] = st["x_own"].cpu().numpy()
    record(out, "ck_resumed", full.run(resume_state=st))
    single = os.path.join(out_dir, "single.npz")
    if os.path.exists(single):
        record(out, "ck_single", full.run(
            resume_state=full.load_checkpoint(single)))
    # write_debug_out: the whole final state, written once
    dbg = RASolver(decompose(A, b, Settings(**BASE, write_debug_out=True),
                             D), mesh=mesh)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        dbg.run()
    finally:
        os.chdir(cwd)
    # FGMRES: a straight run and one stopped after one restart cycle of 4
    fg = dict(accelerator="fgmres", restart_iter=4)
    ff = RASolver(decompose(A, b, Settings(**BASE, **fg), D), mesh=mesh)
    record(out, "fg_straight", ff.run_accelerated())
    fh = RASolver(decompose(A, b, Settings(**{**BASE, "max_iters": 4},
                                           **fg), D), mesh=mesh)
    fpath = os.path.join(out_dir, "fgmres.npz")
    fh.run_accelerated(checkpoint_path=fpath)
    record(out, "fg_resumed", ff.run_accelerated(
        resume_state=ff.load_accel_checkpoint(fpath)))
    # the free-running 1-D tier (4 ranks): one launch, a checkpoint, the
    # rest
    s = free_1d(pmesh.make_mesh(num_ranks=4, device=device), device)
    record_free(out, "fr_straight", *s.run(max_rounds=FREE_1D_ROUNDS))
    fr = os.path.join(out_dir, "free")
    s.run(max_rounds=FREE_1D["chunk_rounds"], checkpoint_path=fr)
    record_free(out, "fr_resumed", *s.run(
        max_rounds=FREE_1D_ROUNDS - FREE_1D["chunk_rounds"],
        resume_state=s.load_checkpoint(fr)))
    out["pid"] = pid


def main(pid: int, nproc: int, port: str, out_dir: str, device: str,
         groups: str):
    pmesh.initialize(f"localhost:{port}", nproc, pid, timeout_s=120)
    dev = torch.device(device)
    mesh = pmesh.make_mesh(num_ranks=D, device=dev)
    out = {}
    for g in groups.split(","):
        if g == "rdma":
            case_rdma(mesh, out, dev)
        elif g == "k4":
            case_k4(mesh, out, dev)
        elif g == "free":
            # the free-running tiers take their own rank counts: 4 ranks
            out.update(case_free(pmesh.make_mesh(num_ranks=4, device=dev),
                                 dev))
        elif g == "ckpt":
            case_ckpt(mesh, out, dev, out_dir)
        else:
            raise ValueError(f"unknown group {g!r}")
    np.savez(os.path.join(out_dir, f"p{pid}.npz"), **out)
    for w in list(mesh.windows.values()):
        w.close()
    pmesh.shutdown()
    print("WORKER_OK", flush=True)


def run_group(nproc: int, out_dir: str, groups: str, device: str = "cpu",
              timeout_s: float = 240) -> list:
    """Run the worker's ``groups`` in ``nproc`` processes; their outputs,
    in process order.  Raises when a worker fails or outlasts
    ``timeout_s``, after killing every one still running
    (``mesh.launch``)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    logs = pmesh.launch(
        [sys.executable, os.path.abspath(__file__), out_dir, device, groups],
        nproc, out_dir, timeout_s, env=env)
    for pid, log in enumerate(logs):
        if "WORKER_OK" not in log:
            raise RuntimeError(f"worker {pid} did not finish:\n{log[-4000:]}")
    res = []
    for pid in range(nproc):
        with np.load(os.path.join(out_dir, f"p{pid}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


if __name__ == "__main__":
    main(int(sys.argv[4]), int(sys.argv[5]), sys.argv[6], sys.argv[1],
         sys.argv[2], sys.argv[3])
