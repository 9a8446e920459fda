"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python -m portbench.run`` from the root of the checkout is the same.)
The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix and metrics are files found by name
(:mod:`portbench.registry`).  A run:

1. builds the operator (NumPy/SciPy) and draws the pool of right-hand sides
   from ``--seed`` on the card, hands both to the program
   (``schwarz_tpu_torch``: ``decompose``, ``RASolver``), and makes the mix's
   warm-up solves: that is set-up, ``setup_s`` from the process's start;
2. measures for ``--seconds``: one client in a closed loop, each solve
   ``RASolver.set_rhs(b_k)`` and the configuration's entry (``run`` or
   ``run_accelerated``), up to the solution returned on the host;
3. with ``--trace 1``, then profiles a few more whole solves
   (:mod:`portbench.devtrace`) and makes the configuration's instrumented
   solves;
4. once the program is freed, holds every solution it returned to the
   configuration's guarantee with the plain reference
   (:mod:`portbench.check`), and prints each number compared beside its
   limit as the last lines on standard error, and the result as one JSON
   line on standard output, last.

A configuration that names ``"processes": P`` runs in P worker processes
of this script, one card each, in lockstep (:mod:`portbench.group`); this
process then starts them and prints their result.

Without a CUDA card, or with fewer than the cell's chips, it exits with 3
and prints no result; if JAX or the JAX package was loaded, in this process
or a worker, with 4; if a worker failed or the group outlasted the run's
bound, with 5.  The per-solve times go to ``$TMPDIR/portbench/``.  Run as
a command it first makes its process steady
(:func:`portbench.steady_process`).
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()
_T_START_MONO = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_HERE)
RUN_PY = os.path.join(_HERE, "run.py")
# run as a script, sys.path[0] is this directory: its modules must not
# shadow the standard library's, so the checkout's root takes its place
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == _HERE:
    sys.path[0] = ROOT
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import portbench  # noqa: E402

if __name__ == "__main__":
    portbench.steady_process()

from portbench import check, devtrace, generator, group, registry  # noqa: E402
from portbench.readings import Readings, Solve  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "schwarz_tpu")
EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4
EXIT_GROUP_FAILED = 5
TOP = 10
# solves under the profiler, and solves through the configuration's
# instrumented entry, in a run with --trace 1
PROFILED_SOLVES = 2
INSTRUMENTED_SOLVES = 2


class NoDevice(RuntimeError):
    pass


def torch_cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``schwarz_tpu_torch`` is neither)."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _log(*parts) -> None:
    print("[portbench]", *parts, file=sys.stderr, flush=True)


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and the program's coarse-space cache off, so that every run pays its
    eigensolves as a user with a new operator does.  The port builds its
    kernels into ``build/torch_kernels`` beside itself."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ.pop("SCHWARZ_TPU_COARSE_CACHE", None)


def make_settings(spec: dict):
    """The program's ``Settings`` from a configuration's ``settings``:
    enum fields by value, nested settings by their fields."""
    import dataclasses
    import enum
    import typing

    from schwarz_tpu_torch import config as prog_config

    def build(cls, values):
        hints = typing.get_type_hints(cls)
        kw = {}
        for key, v in values.items():
            t = hints[key]
            if isinstance(t, type) and issubclass(t, enum.Enum):
                v = t(v)
            elif dataclasses.is_dataclass(t):
                v = build(t, v)
            kw[key] = v
        return cls(**kw)

    return build(prog_config.Settings, spec)


def launch_counters() -> dict:
    """Every launch counter of the program's kernel wrappers loaded so far:
    ``{wrapper: {"launches": n, "launches_by": {key: n}}}``."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("schwarz_tpu_torch.") or mod is None:
            continue
        for fn in list(vars(mod).values()):
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[fn.__name__] = {
                    "launches": n,
                    "launches_by": dict(getattr(fn, "launches_by", {}))}
    return out


def counter_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, a in after.items():
        b = before.get(name, {"launches": 0, "launches_by": {}})
        by = {k: v - b["launches_by"].get(k, 0)
              for k, v in a["launches_by"].items()}
        out[name] = {"launches": a["launches"] - b["launches"],
                     "launches_by": {k: v for k, v in by.items() if v}}
    return out


def card_reading(ids: str = "0") -> str:
    """Name, clocks, power and temperature of the cards ``ids`` (``0``,
    or ``0,1,2,3``) from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", ids, "--query-gpu=name,clocks.sm,"
             "clocks.max.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: str = ROOT, device=None, settings_override=None,
             program_hook=None, t_start: float = None) -> dict:
    """One run of ``workload``; returns ``{"result": the result line's
    object, "checks": the numbers compared}``.  ``device`` None takes CUDA
    card 0 and raises :class:`NoDevice` without one; the CPU tests pass
    ``"cpu"``.  ``settings_override`` replaces settings of the
    configuration (the control's lower precision), and ``program_hook``
    gets the built solver (the tests' planted faults).  A configuration of
    several processes runs in a process group (:mod:`portbench.group`),
    one card a process; its ``t_start`` is on ``time.monotonic``, which
    every process reads alike."""
    bench = registry.load_benchmark(root)
    cell = registry.workload(bench, workload)
    cfg = registry.config(root, cell["config"])
    if group.processes(cfg) > 1:
        return group.run_cell(
            sys.modules[__name__], workload, seed, seconds, trace, root=root,
            bench=bench, cfg=cfg, chips=int(cell["chips"]), device=device,
            settings_override=settings_override, program_hook=program_hook,
            t_start=_T_START_MONO if t_start is None else t_start)
    m = measure(workload, seed, seconds, trace, root=root, device=device,
                settings_override=settings_override,
                program_hook=program_hook,
                t_start=_T_START if t_start is None else t_start)
    chk, limit = judge(m)
    out = result(m["bench"], workload, readings(m), chk, limit, m["kind"],
                 int(m["cell"]["chips"]), m["peak"], root)
    report(m)
    return out


def measure(workload: str, seed: int, seconds: float, trace: bool, *,
            root: str, device, settings_override, program_hook,
            t_start: float, clock=time.perf_counter, team=None) -> dict:
    """Set-up, the window and the traced solves of one run, up to the
    program freed: everything the check, the metrics and the report read.
    ``team`` (:class:`portbench.group.Team`) is a worker's place in a
    process group, None in a run of one process."""
    bench = registry.load_benchmark(root)
    cell = registry.workload(bench, workload)
    cfg = registry.config(root, cell["config"])
    mix = registry.traffic(root, cell["traffic"])
    generator.validate(mix)

    import torch

    split = {"torch import": clock() - t_start}
    t = clock()
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            raise NoDevice(
                f"{workload} needs {cell['chips']} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
    split["cuda init"], t = clock() - t, clock()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    import schwarz_tpu_torch as prog

    split["program import"], t = clock() - t, clock()
    A = registry.operator(root, cfg["operator"]["kind"]).build(
        cfg["operator"])
    split["operator"], t = clock() - t, clock()
    requests = generator.make_requests(mix, A.shape[0], seed, device)
    if team is not None:
        team.agree("pools", group.pool_digest(requests))
    split["requests"], t = clock() - t, clock()
    settings = make_settings({**cfg["settings"], **(settings_override or {})})
    dec = prog.decompose(prog.CSRMatrix.from_scipy(A), requests[0], settings,
                         int(cfg["num_subdomains"]))
    split["decompose"], t = clock() - t, clock()
    if team is None:
        solver = prog.RASolver(dec, device=device)
    else:
        solver = prog.RASolver(dec, mesh=team.mesh)
    sync()
    split["solver"], t = clock() - t, clock()
    if program_hook is not None:
        program_hook(solver)
    entry = getattr(solver, cfg["entry"])
    lead = team is None or team.rank == 0

    def solve(row, call=entry, label=False):
        # traced solves carry the harness's spans, which name the device's
        # idle gaps by what the host was doing
        t0 = clock()
        with devtrace.span("set_rhs", label):
            solver.set_rhs(requests[row])
        t1 = clock()
        with devtrace.span("entry", label):
            res = call()
        t2 = clock()
        hist = res.global_resnorm_history
        return (Solve(row, t2 - t0, t1 - t0, t2 - t1, float(res.solve_time_s),
                      int(res.iters), bool(res.converged),
                      float(hist[-1]) if len(hist) else float("nan")), res)

    for _ in range(int(mix["warmup_solves"])):
        solve(0)
    if team is not None:
        team.mesh.barrier()
    split["warmup"] = clock() - t

    # --- the window ---------------------------------------------------------
    # in a group process 0's clock decides, and every process hears go or
    # stop before each solve, outside its timed interval
    c0 = launch_counters()
    mesh0 = dict(team.mesh.stats) if team is not None else None
    solves, solved = [], []
    t_w0 = clock()
    setup_s = t_w0 - t_start
    deadline = t_w0 + float(seconds)
    while (clock() < deadline if team is None
           else team.go(lead and clock() < deadline)):
        s, res = solve(generator.row(mix, len(solves)))
        solves.append(s)
        if lead:
            solved.append((s.row, res.solution))
    t_w1 = clock()
    window_s = t_w1 - t_w0
    counters = counter_delta(c0, launch_counters())
    mesh_stats = ({k: v - mesh0[k] for k, v in team.mesh.stats.items()}
                  if team is not None else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if not cuda:
        card = "cpu"
    elif team is None:
        card = card_reading()
    elif lead:
        # every card of the group
        n = torch.cuda.device_count()
        card = card_reading(",".join(
            str(i) for i in sorted({p % n for p in range(team.size)})))
    else:
        card = None
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    # --- traced solves, after the window ------------------------------------
    profile, instrumented = None, None
    k = len(solves)
    n_traced = 0
    if trace:
        c1 = launch_counters()
        rows = (generator.row(mix, i) for i in itertools.count(k))
        profile, outs = devtrace.profile_solves(
            lambda: solve(next(rows), label=lead), PROFILED_SOLVES, device)
        profile["counters"] = counter_delta(c1, launch_counters())
        profile["solves"] = [s for s, _ in outs]
        if lead:
            solved += [(s.row, res.solution) for s, res in outs]
        k += len(outs)
        n_traced = len(outs)
        inst = cfg.get("instrumented_entry")
        if inst:
            instrumented = []
            for i in range(INSTRUMENTED_SOLVES):
                s, res = solve(generator.row(mix, k + i),
                               getattr(solver, inst))
                instrumented.append({"stage_timings": res.stage_timings,
                                     "loop_s": s.loop_s, "iters": s.iters})
                if lead:
                    solved.append((s.row, res.solution))

    tail = {"traced solves": clock() - t_w1}
    meta = solver.meta
    plan = getattr(solver, "_plan", {})
    inv = plan.get("factor_inv")
    shapes = dict(S=solver.S_local, R_int=meta.max_interior,
                  R_rows=meta.max_rows, R_ext=meta.max_ext,
                  dtype=settings.dtype,
                  halo_strategy=settings.comm.strategy.value,
                  inverse=tuple(inv.shape) if inv is not None else None,
                  inverse_dtype=(str(inv.dtype).split(".")[-1]
                                 if inv is not None else None))
    tables = {k: plan[k].cpu().numpy() for k in ("ext_segs", "ext_first")
              if k in plan}
    del solver, dec, entry, inv, plan
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if team is not None:
        # every process has freed its program before the check
        team.mesh.barrier()
    tail["freeing"] = clock() - t_w1 - tail["traced solves"]
    return dict(bench=bench, cell=cell, cfg=cfg, mix=mix, A=A,
                requests=requests, solved=solved, solves=solves,
                workload=workload, seed=seed, setup_s=setup_s, split=split,
                window_s=window_s, counters=counters, mesh=mesh_stats,
                peak=peak, card=card, kind=kind, cuda=cuda, profile=profile,
                instrumented=instrumented, shapes=shapes, tables=tables,
                tail=tail,
                counts=(len(solves), n_traced, len(instrumented or ())))


def judge(m: dict) -> tuple:
    """The check, once the program is freed: every solution the run kept
    against the configuration's guarantee; returns it and the limit."""
    limit = float(m["cfg"]["guarantee"]["relative_residual"])
    t = time.perf_counter()
    chk = check.check_solves(m["A"], m["requests"], m["solved"], limit)
    m["tail"]["check"] = time.perf_counter() - t
    _report_residuals(chk["residuals"], m["solves"], m["requests"])
    return chk, limit


def readings(m: dict) -> Readings:
    return Readings(cell=m["workload"], config=m["cfg"], traffic=m["mix"],
                    platform="gpu" if m["cuda"] else "cpu",
                    setup_s=m["setup_s"], setup_split=m["split"],
                    window_s=m["window_s"], solves=m["solves"],
                    counters=m["counters"], shapes=m["shapes"],
                    tables=m["tables"], profile=m["profile"],
                    instrumented=m["instrumented"], mesh=m["mesh"])


def result(bench: dict, workload: str, ctx: Readings, chk: dict,
           limit: float, kind: str, count: int, peak: int,
           root: str) -> dict:
    """The result line's object from the readings, the check and the
    device, and the numbers compared."""
    metrics = {}
    for m in registry.cell_metrics(bench, workload, ctx.profile is not None):
        v = registry.reader(root, m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    gpu = ctx.platform == "gpu"
    dev = {"platform": ctx.platform, "kind": kind if gpu else "cpu",
           "count": int(count), "memory_peak_bytes": int(peak)}
    out = {"correct": chk["failed"] == 0 and chk["checked"] > 0,
           "attempted": chk["checked"], "failed": chk["failed"],
           "metrics": metrics, "device": dev}
    profile = ctx.profile
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        out["breakdown"] = {
            "device_ops": [[n[:160], s] for n, (_, s) in sorted(
                profile["kernels"].items(), key=lambda kv: -kv[1][1])][:TOP],
            "idle_gaps": [[n[:160], s] for n, s in sorted(
                profile["idle_by_host"].items(), key=lambda kv: -kv[1])][:TOP]}
    checks = {"rel_residual_max": {"value": chk["rel_residual_max"],
                                   "limit": limit}}
    out["checks"] = checks
    return {"result": out, "checks": checks}


def report(m: dict) -> None:
    _report(m["workload"], m["seed"], m["setup_s"], m["split"], m["solves"],
            m["window_s"], m["counters"], m["peak"], m["card"], m["profile"],
            m["instrumented"], m["mesh"])
    _log("after the window: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in m["tail"].items()))


def _report(workload, seed, setup_s, split, solves, window_s, counters, peak,
            card, profile, instrumented, mesh=None) -> None:
    """The run's details: a summary on standard error, the per-solve
    times in ``$TMPDIR/portbench/<cell>.<seed>.json``."""
    import numpy as np

    walls = np.array([s.wall_s for s in solves])
    p90 = float(np.percentile(walls, 90))
    _log(f"cell {workload} seed {seed}: set-up {setup_s:.4f} s "
         + " ".join(f"{k} {v:.4f}" for k, v in split.items()))
    _log(f"window {window_s:.4f} s, {len(solves)} solves: min "
         f"{walls.min():.6f} median {float(np.median(walls)):.6f} p90 "
         f"{p90:.6f} max {walls.max():.6f} s; {int((walls > p90).sum())} "
         f"solves beyond the p90; first solve {walls[0]:.6f} s; set_rhs "
         f"median {float(np.median([s.set_rhs_s for s in solves])):.6f} s, "
         f"program loop median "
         f"{float(np.median([s.loop_s for s in solves])):.6f} s; outer "
         f"iterations {sorted({s.iters for s in solves})}, unconverged by "
         f"the program's flag {sum(not s.converged for s in solves)}")
    _log(f"launches in the window: "
         + ", ".join(f"{k} {v['launches']}" for k, v in counters.items()
                     if v["launches"]))
    if mesh is not None:
        _log("mesh layer in the window: {} calls, {:.6f} s ({:.6f} s "
             "waiting for the device), {} bytes".format(
                 mesh["calls"], mesh["seconds"], mesh["wait_seconds"],
                 mesh["bytes"]))
    _log(f"device memory peak {peak} bytes; card: {card}")
    if profile is not None:
        _log(f"traced stretch: {len(profile['solves'])} solves, window "
             f"{profile['window_s']:.6f} s, device busy "
             f"{profile['busy_s']:.6f} s; launches "
             + ", ".join(f"{k} {v['launches']}"
                         for k, v in profile["counters"].items()
                         if v["launches"]))
    if instrumented:
        for i in instrumented:
            _log("instrumented solve: loop {:.6f} s, {} iterations; ".format(
                i["loop_s"], i["iters"]) + ", ".join(
                f"{k} {v['total']:.6f}" for k, v in
                (i["stage_timings"] or {}).items()))
    out_dir = os.path.join(tempfile.gettempdir(), "portbench")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{workload}.{seed}.json"), "w") as f:
        json.dump({"setup_s": setup_s, "setup_split": split,
                   "window_s": window_s, "card": card,
                   "memory_peak_bytes": peak,
                   "solves": [vars(s) for s in solves]}, f)


def _report_residuals(residuals, solves, requests) -> None:
    """The reference's residuals, and the program's last history entry over
    ||b|` beside them (FGMRES: its estimate), on standard error."""
    import numpy as np

    r = np.array(residuals)
    est = np.array([s.hist_last / np.linalg.norm(requests[s.row])
                    for s in solves])
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = r[:len(est)] / est
    _log(f"reference residuals of {len(r)} solves: min {r.min():.6e} "
         f"median {float(np.median(r)):.6e} max {r.max():.6e}; the "
         f"program's last history entry / ||b|| of the window's: max "
         f"{est.max():.6e}, reference over it {ratio.min():.9f} to "
         f"{ratio.max():.9f}")


def _plain(v):
    """A number for the JSON line; a non-finite one as its name."""
    return v if math.isfinite(v) else str(v)


def emit(out: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    result = out["result"]
    for name, c in out["checks"].items():
        c["value"] = _plain(c["value"])
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}: {result['failed']} "
          f"of {result['attempted']} solves above the limit",
          file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--group-worker"]:
        return group.worker_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except NoDevice as e:
        print(f"[portbench] no result: {e}", file=sys.stderr)
        return EXIT_NO_DEVICE
    except group.GroupFailed as e:
        print(f"[portbench] no result: {e}", file=sys.stderr)
        return EXIT_GROUP_FAILED
    found = sorted(set(forbidden_modules()) | set(out.pop("forbidden", ())))
    if found:
        print(f"[portbench] no result: JAX or the JAX package was loaded: "
              f"{found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
