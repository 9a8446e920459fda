"""Readings behind choices of the card's checks, printed as text.

``gmres``: GMRES locals on ``advection_diffusion_2d`` (4 subdomains,
overlap 3, restart 20, at most 40 inner iterations, Jacobi, outer tolerance
1e-6) at 32^2 with local tolerance 1e-6 and 1e-10, and at 16^2 with 1e-6
(the form of the card's parity case in ``test_torch_cuda.py``): the largest
relative gap between two runs' global residual histories and its reading
against the float64 bar, and at 32^2 the gap outer iteration by outer
iteration beside the number of subdomains whose inner iteration counts
differ.  The pairs are the card against the CPU, and the CPU against the
CPU with the rhs perturbed at the rounding level (each entry times
1 + 1e-16 u, u standard normal, five seeds), which stands for another
summation order.  Without a card only the CPU pairs run.

``profile``: how often the profiler's record of one solve misses a K1 or K2
launch that the wrappers counted, over many windows, with the counted run
placed at the window's edges (``bare``: it starts and ends the window) and
away from them (``padded``: a synchronize and a 20 ms wait on each side),
each for 40 s of windows, twice in turn.  Card only.

``exchange``: the same for one exchange (one K2 launch) padded so, the form
of ``chip_smoke.py``'s exchange count, for 120 s of windows; for a window
that misses its launch, how many host-side records (operators and CUDA
runtime calls) it still holds.  Card only.

``k1``: K1 (``ops/dia_kernel.py``) at the flagship's shapes (16 x 21504
rows: the operator in float64 and float32 with offsets -512, -1, 0, 1, 512,
FSAI's G and G^T in float32), the campaign's (16 x 23552, float64) and the
direct phase's (64 x 4992, float64), on random bands: each single
product, the chain G^T (G r) at tiles of 256-2048 rows beside two single
launches, and K1 and K8, each timed after a flush of L2 that leaves it
dirty (a 128 MB ``zero_``) and clean (a 128 MB sum), in turns.  Card
only.

``mesh``: the host time of one collective of ``parallel/mesh.py`` in
groups of 2 and 4 processes on localhost (on the card when there is one,
else on the CPU), each process's medians over repeated calls with the
device idle between them: a gather of one float64 (the coarse CG's), of
1 MB a process (the flagship's x_own), a shift of 3 KB a rank (a neighbour
round), and gloo's own gather of one float64 host value (no staging); each
group with the processes' thread count left as it is and set to one
(``OMP_NUM_THREADS=1``).

``mesh_async``: the waits of the kernels whose ranks span processes, on
the card, in one process and in a group of 2 on the one card (each process
reaching the other's ranks through the CUDA IPC window): K4 on the
synchronous slice's plan (``laplacian_2d(1024)``, 16 subdomains on 16
ranks, float32), 50 put exchanges, their mean ms (CUDA events around each
launch) and the longest wait of a rank; K5 on the converging 1-D solve of
``chip_smoke.py`` phase 10 (``laplacian_2d(64)``, 8 ranks), its ms per
16-round launch and the longest wait.  The kernels keep the longest wait
across processes only: it reads 0 in one process.  Card only.

    python tests/torch_card_readings.py [gmres] [profile] [exchange] [k1]
        [mesh] [mesh_async]
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from schwarz_tpu_torch import LocalSolver, Precond, Settings, solve  # noqa
from schwarz_tpu_torch.core.decompose import decompose  # noqa: E402
from schwarz_tpu_torch.models import (advection_diffusion_2d,  # noqa: E402
                                      generate_rhs, laplacian_2d)
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv  # noqa: E402
from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext  # noqa: E402


def _gmres_settings(local_tolerance):
    return Settings(overlap=3, tolerance=1e-6, max_iters=400,
                    spmv_format="dia", local_solver=LocalSolver.iterative_gmres,
                    restart_iter=20, local_max_iters=40,
                    local_tolerance=local_tolerance, precond=Precond.jacobi)


def _compare(tag, ra, rb, detail):
    """The largest relative gap of two global residual histories and its
    reading against the float64 bar (rtol 1e-8 plus 1e-12 of the largest
    entry; at most 1 passes)."""
    ha, hb = ra.global_resnorm_history, rb.global_resnorm_history
    if len(ha) != len(hb):
        print(f"{tag}: iterations {ra.iters} / {rb.iters}", flush=True)
        return
    gap = np.abs(ha / hb - 1)
    bar = (np.abs(ha - hb) / (1e-8 * hb + 1e-12 * hb.max())).max()
    print(f"{tag}: iterations {ra.iters} / {rb.iters}, largest history gap "
          f"{gap.max():.3e}, float64 bar {bar:.4f}", flush=True)
    if detail:
        differ = (ra.inner_iters_history != rb.inner_iters_history).sum(1)
        print("  by outer iteration (gap / subdomains whose inner counts "
              "differ): " + " ".join(f"{k}:{g:.1e}/{d}" for k, (g, d)
                                     in enumerate(zip(gap, differ))),
              flush=True)


def gmres_readings():
    for n, lt in ((32, 1e-6), (32, 1e-10), (16, 1e-6)):
        A = advection_diffusion_2d(n)
        b = generate_rhs(A.n)
        s = _gmres_settings(lt)
        cpu = solve(A, b, s, 4, device="cpu")
        for seed in range(5):
            u = np.random.default_rng(seed).standard_normal(A.n)
            _compare(f"{n}^2, local tolerance {lt:g}: CPU against CPU with "
                     f"the rhs perturbed by 1e-16 (seed {seed})",
                     solve(A, b * (1 + 1e-16 * u), s, 4, device="cpu"), cpu,
                     detail=seed == 0 and n == 32)
        if torch.cuda.is_available():
            _compare(f"{n}^2, local tolerance {lt:g}: card against CPU",
                     solve(A, b, s, 4, device="cuda"), cpu, detail=n == 32)


def profile_readings(seconds=40.0, pad_s=0.02):
    from torch.profiler import ProfilerActivity, profile

    from schwarz_tpu_torch import RASolver

    # a short solve keeps the profiler's record, and so each window, small
    A = laplacian_2d(64)
    s = Settings(overlap=3, tolerance=1e-8, max_iters=4, local_max_iters=4,
                 spmv_format="dia")
    solver = RASolver(decompose(A, generate_rhs(A.n), s, 4))
    solver.run()

    def counted():
        dia_spmv.launches = assemble_x_ext.launches = 0
        torch.cuda.synchronize()
        solver.run()
        torch.cuda.synchronize()
        return dia_spmv.launches, assemble_x_ext.launches

    # each variant runs for a fixed time, twice, in turn
    for variant in ("bare", "padded", "bare", "padded"):
        windows, misses, where = 0, 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if variant == "padded":
                    torch.cuda.synchronize()
                    time.sleep(pad_s)
                want = counted()
                if variant == "padded":
                    time.sleep(pad_s)
            events = [e for e in prof.key_averages()
                      if "CUDA" in str(getattr(e, "device_type", ""))]
            got = (sum(e.count for e in events if "dia_spmv_" in e.key),
                   sum(e.count for e in events if "assemble_kernel" in e.key))
            windows += 1
            if got != want:
                misses += 1
                seq = ["K1" if "dia_spmv" in e.name else "K2"
                       for e in sorted(
                           (e for e in prof.events()
                            if "dia_spmv_" in e.name
                            or "assemble_kernel" in e.name),
                           key=lambda e: e.time_range.start)]
                where.append(f"{got} of {want}, the record starts "
                             f"{seq[:3]} and ends {seq[-3:]}")
        print(f"profile {variant}: {misses} of {windows} windows miss a "
              f"launch ({time.perf_counter() - t0:.1f} s); {where[:6]}",
              flush=True)


def exchange_readings(seconds=120.0, pad_s=0.02):
    from torch.profiler import ProfilerActivity, profile

    from schwarz_tpu_torch import RASolver

    A = laplacian_2d(64)
    s = Settings(overlap=3, tolerance=1e-8, max_iters=4, spmv_format="dia")
    solver = RASolver(decompose(A, generate_rhs(A.n), s, 4))
    m = solver.meta
    x = torch.randn((m.num_subdomains, m.max_interior), device="cuda",
                    dtype=solver.settings.value_dtype)
    solver._exchange(x)
    windows, misses, where = 0, 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(pad_s)
            assemble_x_ext.launches = 0
            solver._exchange(x)
            torch.cuda.synchronize()
            want = assemble_x_ext.launches
            time.sleep(pad_s)
        events = prof.events()
        dev = [e.name for e in events
               if "CUDA" in str(getattr(e, "device_type", ""))]
        windows += 1
        if len(dev) != want:
            misses += 1
            runtime = sum("Launch" in e.name or "Synchronize" in e.name
                          for e in events)
            where.append(f"window {windows}: {len(dev)} device records of "
                         f"{want} launch(es), {len(events)} records in all, "
                         f"{runtime} of them CUDA runtime calls")
    print(f"exchange padded: {misses} of {windows} windows miss the launch "
          f"({time.perf_counter() - t0:.1f} s); {where[:8]}", flush=True)


def k1_readings(reps=50):
    from chip_smoke import Smoke

    from schwarz_tpu_torch import diagnostics as dg
    from schwarz_tpu_torch.ops.dia_kernel import (default_tile, dia_spmv,
                                                  dia_spmv_chain)

    sm = Smoke(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def band(S, R, offsets, dtype):
        d = torch.randn((S, len(offsets), R), generator=gen, device="cuda",
                        dtype=dtype)
        r = torch.arange(R, device="cuda")
        for k, o in enumerate(offsets):
            d[:, k, (r + o < 0) | (r + o >= R)] = 0
        return d

    a_off, go, uo = (-512, -1, 0, 1, 512), (-512, -1, 0), (0, 1, 512)
    shapes = {"flagship A_f64": (16, 21504, a_off, torch.float64),
              "flagship A_f32": (16, 21504, a_off, torch.float32),
              "flagship G": (16, 21504, go, torch.float32),
              "flagship GT": (16, 21504, uo, torch.float32),
              "campaign": (16, 23552, a_off, torch.float64),
              "direct": (64, 4992, (-78, -1, 0, 1, 78), torch.float64)}
    for name, (S, R, offs, dt) in shapes.items():
        dia = band(S, R, offs, dt)
        x = torch.randn((S, R + 13), generator=gen, device="cuda",
                        dtype=dt)[:, :R]
        got = {}
        for turn in range(2):
            for fl in ("write", "read"):
                got.setdefault(fl, []).append(sm.ms(
                    lambda: dia_spmv(offs, dia, x), reps, fl))
        print(f"K1 {name} {tuple(dia.shape)}: " + ", ".join(
            f"after a {fl} flush {' / '.join(f'{t:.5f}' for t in ts)}"
            for fl, ts in got.items()) + " ms", flush=True)
    S, R = 16, 21504
    gd, ud = band(S, R, go, torch.float32), band(S, R, uo, torch.float32)
    r = torch.randn((S, R), generator=gen, device="cuda")
    got = {}
    for turn in range(2):
        for fl in ("write", "read"):
            got.setdefault(f"two launches ({fl})", []).append(sm.ms(
                lambda: dia_spmv(uo, ud, dia_spmv(go, gd, r)), reps, fl))
            for tile in (256, 512, 1024, 1344, 1792, 2048):
                got.setdefault(f"tile {tile} ({fl})", []).append(sm.ms(
                    lambda: dia_spmv_chain(go, gd, uo, ud, r, tile=tile),
                    reps, fl))
    print(f"K1 chain G^T (G r), flagship (16, 3, 21504) float32, default "
          f"tile {default_tile(S, R, r.device)}: " + ", ".join(
              f"{k} {' / '.join(f'{t:.5f}' for t in ts)}"
              for k, ts in got.items()) + " ms", flush=True)
    x8 = torch.randn((256, 256), generator=gen, device="cuda")
    got = {}
    for turn in range(2):
        for fl in ("write", "read"):
            got.setdefault(fl, []).append(sm.ms(lambda: dg.smoke_x2(x8),
                                                reps, fl))
    print("K8 (256, 256): " + ", ".join(
        f"after a {fl} flush {' / '.join(f'{t:.5f}' for t in ts)}"
        for fl, ts in got.items()) + " ms", flush=True)


def _median_us(fn, reps, device):
    samples = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return 1e6 * float(np.median(samples))


def mesh_child(pid, nproc, port):
    """One process of ``mesh_readings``' group: prints its medians."""
    import torch.distributed as dist

    from schwarz_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize(f"localhost:{port}", nproc, pid, timeout_s=120)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    m = pmesh.make_mesh(num_ranks=4 * nproc, device=dev)
    one = torch.ones((), dtype=torch.float64, device=dev)
    big = torch.ones(131072, dtype=torch.float64, device=dev)
    buf = torch.ones((4, 384), dtype=torch.float64, device=dev)
    host = torch.ones(1, dtype=torch.float64)
    outs = [torch.empty(1, dtype=torch.float64) for _ in range(nproc)]
    got = {}
    for name, fn, reps in (
            ("scalar gather", lambda: m.psum(one), 300),
            ("1 MB gather", lambda: m.all_gather(big), 60),
            ("3 KB-a-rank shift", lambda: m.shift(buf, 1), 300),
            ("gloo scalar gather", lambda: dist.all_gather(outs, host), 300)):
        fn()
        got[name] = _median_us(fn, reps, dev)
    print("MESH " + " ".join(f"{k}={v:.1f}" for k, v in got.items()),
          flush=True)
    pmesh.shutdown()


def mesh_readings():
    from schwarz_tpu_torch.parallel import mesh as pmesh

    here = os.path.dirname(os.path.abspath(__file__))
    for threads in (None, "1"):
        for nproc in (2, 4):
            env = dict(os.environ)
            if threads:
                env["OMP_NUM_THREADS"] = threads
            logs = pmesh.launch(
                [sys.executable, os.path.abspath(__file__), "mesh-child"],
                nproc, os.path.join(os.path.dirname(here), "build",
                                    "mesh_readings"), 300, env=env)
            for pid, out in enumerate(logs):
                line = [ln for ln in out.splitlines() if ln.startswith("MESH")]
                print(f"mesh, {nproc} processes, OMP_NUM_THREADS="
                      f"{threads or 'unset'}, process {pid}, median us: "
                      f"{line[0][5:] if line else out[-2000:]}", flush=True)


def _async_waits():
    """K4's ms per exchange and longest wait on the slice's plan (16
    ranks), then K5's ms per launch and longest wait on the 64^2 solve (8
    ranks), on the default group's processes (one without a group)."""
    from schwarz_tpu_torch.parallel import mesh as pmesh

    from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
    from schwarz_tpu_torch.ops.async_ras_kernel import async_ras_rounds
    from schwarz_tpu_torch.ops.rdma_kernel import (rdma_exchange_launch,
                                                   rdma_shift_finish)
    from schwarz_tpu_torch.parallel.neighbor_exchange import (
        build_neighbor_plan, exchange_rounds)

    mesh = pmesh.make_mesh(num_ranks=16)
    A = laplacian_2d(1024)
    s = Settings(overlap=3, dtype="float32", row_pad_multiple=1024,
                 spmv_format="dia", precond=Precond.jacobi)
    dec = decompose(A, generate_rhs(A.n, random=False), s, 16)
    rounds = exchange_rounds(build_neighbor_plan(
        dec, 16, process_of=mesh.process_of), mesh.device, mesh)
    x = torch.ones((16 // mesh.num_processes, dec.meta.max_interior),
                   dtype=torch.float32, device=mesh.device)
    rdma_shift_finish([rdma_exchange_launch(x, rounds, None, "put")[1]])
    pairs, sts = [], []
    for _ in range(50):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sts.append(rdma_exchange_launch(x, rounds, None, "put")[1])
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    rdma_shift_finish(sts)
    k4 = sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
    k4_wait = rounds._card.longest_wait_ns() / 1e6
    A64 = laplacian_2d(64)
    solver = AsyncRASolver(A64, np.ones(A64.n), 8, overlap=2,
                           tolerance=1e-4, ninner=20, chunk_rounds=16,
                           mesh=pmesh.make_mesh(num_ranks=8))
    waits, t = [], []
    state = solver.init_state()
    x5 = state[0].reshape(solver.Dl, -1)
    st = [x5, *state[1:]]
    d = solver._dev
    p = solver.plan
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = list(async_ras_rounds(
            d["dia"], d["b"], d["dinv"], d["mask_dom"], d["mask_int"], *st,
            offsets=p.offsets, total=p.total, hw=p.hw, rounds=16,
            staleness=1, ninner=20, tol=1e-4, mesh=solver._mesh))
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
        waits.append(async_ras_rounds.longest_wait_ns / 1e6)
    return (f"K4 {k4:.4f} ms per exchange, longest wait {k4_wait:.3f} ms; "
            f"K5 {1e3 * float(np.median(t)):.3f} ms per 16-round launch "
            f"(host clock, median of 10), longest wait "
            f"{max(waits):.3f} ms, cluster {async_ras_rounds.cluster}")


def mesh_async_child(pid, nproc, port):
    from schwarz_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize(f"localhost:{port}", nproc, pid, timeout_s=120)
    print("MESH_ASYNC " + _async_waits(), flush=True)
    pmesh.shutdown()


def mesh_async_readings():
    from schwarz_tpu_torch.parallel import mesh as pmesh

    print("mesh_async, one process: " + _async_waits(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    logs = pmesh.launch(
        [sys.executable, os.path.abspath(__file__), "mesh-async-child"], 2,
        os.path.join(os.path.dirname(here), "build", "mesh_async_readings"),
        300)
    for pid, out in enumerate(logs):
        line = [ln for ln in out.splitlines() if ln.startswith("MESH_ASYNC")]
        print(f"mesh_async, process {pid} of 2: "
              f"{line[0][11:] if line else out[-2000:]}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["mesh-child"]:
        mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["mesh-async-child"]:
        mesh_async_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    what = sys.argv[1:] or ["gmres", "profile"]
    if torch.cuda.is_available():
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    else:
        print("no card: the CPU readings only", flush=True)
    if "gmres" in what:
        gmres_readings()
    if "profile" in what and torch.cuda.is_available():
        profile_readings()
    if "exchange" in what and torch.cuda.is_available():
        exchange_readings()
    if "k1" in what and torch.cuda.is_available():
        k1_readings()
    if "mesh" in what:
        mesh_readings()
    if "mesh_async" in what and torch.cuda.is_available():
        mesh_async_readings()
