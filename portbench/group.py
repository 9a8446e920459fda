"""Cells across a process group: one process per card, as schwarz-lib
deploys one MPI rank per GPU.

A configuration that names ``"processes": P`` (1 when the key is absent)
runs its cell in P worker processes of ``run.py``.  The process that the
benchmark's command starts is the launcher: it starts the workers
(:func:`launch`, the role of ``mpirun``) and, while they start, refuses
fewer than P cards.  Worker p joins a gloo group through the program's own
``parallel/mesh.py`` (``initialize``, then ``make_mesh(num_ranks=
num_subdomains)``) and runs on ``cuda:p``; worker 0 builds the port's
kernels, once, before any worker loads them.  Each makes the run's set-up
and solves as the one-process path does, with the program's
``RASolver(dec, mesh=mesh)``:

- every worker draws the pool from ``--seed`` on its card; set-up fails
  when the pools' checksums differ;
- the window runs in lockstep: before each solve process 0, whose clock
  decides, broadcasts go or stop, outside the solve's timed interval;
- with ``--trace 1`` every worker profiles its own card; the counters,
  shapes, tables and the breakdown are process 0's, the device's busy and
  window seconds the mean over the cards;
- once every worker has freed its program, process 0 holds every solution
  it returned to the guarantee with the plain reference.

``configs/flagship_lap2d_512_4proc.json`` is such a configuration; no cell
of ``BENCHMARK.json`` runs it yet (``PERF.md``).

Each worker writes what it read to ``p<pid>.pkl`` in the run's work
directory (``$TMPDIR/portbench/group/<cell>.<seed>``); the launcher
requires every worker to have made the same solves and prints the one
result line.  A worker that fails, or a run that outlasts its bound
(:func:`run_bound`), has every worker and whatever it started killed, and
the launcher exits without a result.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench import registry

# what a run may take beyond BENCHMARK.json's run_seconds, and the most
# that a checkout's first run, which builds the kernels, may take
RUN_SPARE_S = 60.0
FIRST_RUN_S = 1200.0
TAIL = 3000          # characters of each worker's log shown on a failure
BUILT = "build_s"    # process 0's kernel build seconds, in the work directory


class GroupFailed(RuntimeError):
    pass


def processes(cfg: dict) -> int:
    return int(cfg.get("processes", 1))


def pool_digest(requests: np.ndarray) -> str:
    """A checksum of the pool's bits: each row's wrapping sum and XOR of
    its 64-bit words, hashed in row order."""
    u = np.ascontiguousarray(requests).view(np.uint64)
    rows = np.concatenate([u.sum(axis=1), np.bitwise_xor.reduce(u, axis=1)])
    return hashlib.sha256(rows.tobytes()).hexdigest()


class Team:
    """A worker's place in the group, and the harness's own collectives
    over it (the default process group, outside ``Mesh.stats``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank = mesh.process_index
        self.size = mesh.num_processes

    def go(self, flag: bool) -> bool:
        """Process 0's ``flag``, in every process."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def agree(self, what: str, value) -> None:
        """Raise unless every process holds the same ``value``."""
        import torch.distributed as dist

        got = [None] * self.size
        dist.all_gather_object(got, value)
        if any(v != got[0] for v in got):
            raise RuntimeError(f"the processes' {what} differ: {got}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _kill(procs) -> None:
    """Kill each worker's session, whatever it started with it, and reap
    the workers."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        p.wait()


def launch(argv, nproc: int, work: str, timeout_s, started=None) -> list:
    """Run ``nproc`` processes of ``argv + [pid, nproc, port]``, each in a
    session of its own with its output in ``work/log<pid>.txt``; returns
    the logs once every one exited 0.  ``started()``, if given, runs once
    they are started; what it raises ends the group.  ``timeout_s`` is
    the seconds from the start, or a function that gives them as the group
    runs.  The first process to fail, or a group that outlasts them, has
    every session killed (a peer waiting in a collective would otherwise
    wait out its own timeout), and the call raises :class:`GroupFailed`
    with the ends of the logs.  The harness's own launcher rather than the
    program's ``mesh.launch``: killing a session also ends what the worker
    started, such as the program's eigensolve workers."""
    port = _free_port()
    paths = [os.path.join(work, f"log{pid}.txt") for pid in range(nproc)]
    procs = []
    try:
        for pid, path in enumerate(paths):
            with open(path, "w") as log:
                procs.append(subprocess.Popen(
                    list(argv) + [str(pid), str(nproc), str(port)],
                    stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        t0 = time.monotonic()
        limit = timeout_s if callable(timeout_s) else lambda: timeout_s
        if started is not None:
            started()
        while time.monotonic() - t0 < limit():
            rcs = [p.poll() for p in procs]
            if any(rcs) or all(rc == 0 for rc in rcs):
                break
            time.sleep(0.05)
    finally:
        _kill(procs)
    logs = []
    for path in paths:
        with open(path, errors="replace") as f:
            logs.append(f.read())
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise GroupFailed(
            f"workers exited {rcs} (negative: killed, after {limit():.0f}"
            f" s or a peer's failure)\n" + "\n".join(
                f"--- worker {pid} (exit {rc}):\n{log[-TAIL:]}"
                for pid, (rc, log) in enumerate(zip(rcs, logs))))
    return logs


def hook_name(hook) -> str:
    """A planted fault as ``module:name``, which a worker imports."""
    return f"{hook.__module__}:{hook.__qualname__}"


def _hook(name):
    if name is None:
        return None
    module, attr = name.split(":")
    return getattr(importlib.import_module(module), attr)


def run_bound(run_seconds: float, work: str):
    """The seconds a group may run from its start, as it runs:
    BENCHMARK.json's ``run_seconds`` + 60, as for any run, and beyond that
    the seconds that process 0 spent building the kernels, which only a
    checkout's first run spends, up to the first run's 1200 s.  While the
    build runs its seconds are not known, and the first run's bound
    holds."""
    bound = float(run_seconds) + RUN_SPARE_S
    mark = os.path.join(work, BUILT)

    def limit() -> float:
        try:
            with open(mark) as f:
                text = f.read()
        except OSError:
            return bound
        try:
            return min(bound + float(text), FIRST_RUN_S)
        except ValueError:
            return FIRST_RUN_S

    return limit


def run_cell(run, workload: str, seed: int, seconds: float, trace: bool, *,
             root: str, bench: dict, cfg: dict, chips: int, device,
             settings_override, program_hook, t_start: float) -> dict:
    """The launcher's side of a run (``run.run_cell`` for a configuration
    of several processes); returns what ``run.run_cell`` does, with the
    workers' loaded forbidden modules under ``forbidden``.  ``device``
    "cpu" runs the workers on the CPU (the tests)."""
    P = processes(cfg)
    work = os.path.join(tempfile.gettempdir(), "portbench", "group",
                        f"{workload}.{seed}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    spec = dict(workload=workload, seed=seed, seconds=seconds, trace=trace,
                root=root, device=None if device is None else str(device),
                settings_override=settings_override,
                program_hook=(None if program_hook is None
                              else hook_name(program_hook)),
                t_start=t_start)
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    def cards():
        # while the workers start: the launcher's own look for the cards
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            raise run.NoDevice(
                f"{workload} needs {chips} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")

    argv = [sys.executable, run.RUN_PY, "--group-worker", spec_path]
    logs = launch(argv, P, work, run_bound(bench["run_seconds"], work),
                  started=cards if device is None else None)
    outs = []
    for pid in range(P):
        with open(os.path.join(work, f"p{pid}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    counts = [o["counts"] for o in outs]
    if any(c != counts[0] for c in counts):
        raise GroupFailed(f"the workers made different solves: {counts}")
    for line in logs[0].splitlines():
        print(line, file=sys.stderr)
    lead = outs[0]
    busy = [o["busy"] for o in outs if o["busy"] is not None]
    if busy:
        # the device's busy and window seconds over every card
        lead["ctx"].profile["busy_s"] = float(np.mean([b[0] for b in busy]))
        lead["ctx"].profile["window_s"] = float(np.mean([b[1] for b in busy]))
    out = run.result(lead["bench"], workload, lead["ctx"], lead["chk"],
                     lead["limit"], lead["kind"], chips,
                     max(o["peak"] for o in outs), root)
    out["forbidden"] = sorted({n for o in outs for n in o["forbidden"]})
    return out


def _mark(work: str, text: str) -> None:
    """Write the build mark that :func:`run_bound` reads, whole."""
    part = os.path.join(work, BUILT + ".part")
    with open(part, "w") as f:
        f.write(text)
    os.replace(part, os.path.join(work, BUILT))


def worker_main(argv) -> int:
    """One worker: ``run.py --group-worker SPEC PID NPROC PORT``."""
    import ctypes

    spec_path, pid, nproc, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    try:
        # die with the launcher (PR_SET_PDEATHSIG)
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    with open(spec_path) as f:
        spec = json.load(f)
    import torch

    from portbench import run
    from schwarz_tpu_torch.parallel import mesh as pmesh

    cfg = registry.config(spec["root"], registry.workload(
        registry.load_benchmark(spec["root"]),
        spec["workload"])["config"])
    device = spec["device"]
    if device is None:
        # process p on card p (p modulo the cards where they are shared)
        torch.cuda.set_device(pid % torch.cuda.device_count())
    pmesh.initialize(f"localhost:{port}", nproc, pid,
                     timeout_s=FIRST_RUN_S)
    mesh = pmesh.make_mesh(num_ranks=int(cfg["num_subdomains"]),
                           device=device)
    t_join = time.monotonic()
    work = os.path.dirname(spec_path)
    if device is None:
        # the kernels built once, by process 0, before any process loads
        # them; the launcher's bound leaves their seconds out
        if pid == 0:
            from schwarz_tpu_torch.ops import cuda_build

            _mark(work, "building")
            cuda_build.build_all()
            _mark(work, repr(time.monotonic() - t_join))
        mesh.barrier()
    team = Team(mesh)
    m = run.measure(spec["workload"], spec["seed"], spec["seconds"],
                    spec["trace"], root=spec["root"], device=mesh.device,
                    settings_override=spec["settings_override"],
                    program_hook=_hook(spec["program_hook"]),
                    t_start=spec["t_start"], clock=time.monotonic, team=team)
    # "torch import" runs from the launcher's start: the workers' start,
    # imports and the group's join
    t0 = m["split"].pop("torch import")
    build = t0 - (t_join - spec["t_start"])
    m["split"] = {"to the group's join": t0 - build,
                  "kernel build (process 0)": build, **m["split"]}
    out = {"counts": m["counts"], "peak": m["peak"],
           "busy": ((m["profile"]["busy_s"], m["profile"]["window_s"])
                    if m["profile"] is not None else None)}
    if team.rank == 0:
        chk, limit = run.judge(m)
        out.update(bench=m["bench"], ctx=run.readings(m), chk=chk,
                   limit=limit, kind=m["kind"])
        run.report(m)
    out["forbidden"] = run.forbidden_modules()
    with open(os.path.join(work, f"p{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    pmesh.shutdown()
    return 0
