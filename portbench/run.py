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

Without a CUDA card, or with fewer than the cell's chips, it exits with 3
and prints no result; if JAX or the JAX package was loaded, with 4.  The
per-solve times go to ``$TMPDIR/portbench/``.  Run as a command it first
makes its process steady (:func:`portbench.steady_process`).
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

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
# run as a script, sys.path[0] is this directory: its modules must not
# shadow the standard library's, so the checkout's root takes its place
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == _HERE:
    sys.path[0] = ROOT
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import portbench  # noqa: E402

if __name__ == "__main__":
    portbench.steady_process()

from portbench import check, devtrace, generator, registry  # noqa: E402
from portbench.readings import Readings, Solve  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "schwarz_tpu")
EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4
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


def card_reading() -> str:
    """Name, clocks, power and temperature of card 0 from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,clocks.sm,"
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
    gets the built solver (the tests' planted faults)."""
    t_start = _T_START if t_start is None else t_start
    clock = time.perf_counter
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
    split["requests"], t = clock() - t, clock()
    settings = make_settings({**cfg["settings"], **(settings_override or {})})
    dec = prog.decompose(prog.CSRMatrix.from_scipy(A), requests[0], settings,
                         int(cfg["num_subdomains"]))
    split["decompose"], t = clock() - t, clock()
    solver = prog.RASolver(dec, device=device)
    sync()
    split["solver"], t = clock() - t, clock()
    if program_hook is not None:
        program_hook(solver)
    entry = getattr(solver, cfg["entry"])

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
    split["warmup"] = clock() - t

    # --- the window ---------------------------------------------------------
    c0 = launch_counters()
    solves, solved = [], []
    t_w0 = clock()
    setup_s = t_w0 - t_start
    deadline = t_w0 + float(seconds)
    while clock() < deadline:
        s, res = solve(generator.row(mix, len(solves)))
        solves.append(s)
        solved.append((s.row, res.solution))
    window_s = clock() - t_w0
    counters = counter_delta(c0, launch_counters())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card = card_reading() if cuda else "cpu"

    # --- traced solves, after the window ------------------------------------
    profile, instrumented = None, None
    k = len(solves)
    if trace:
        c1 = launch_counters()
        rows = (generator.row(mix, i) for i in itertools.count(k))
        profile, outs = devtrace.profile_solves(
            lambda: solve(next(rows), label=True), PROFILED_SOLVES, device)
        profile["counters"] = counter_delta(c1, launch_counters())
        profile["solves"] = [s for s, _ in outs]
        solved += [(s.row, res.solution) for s, res in outs]
        k += len(outs)
        inst = cfg.get("instrumented_entry")
        if inst:
            instrumented = []
            for i in range(INSTRUMENTED_SOLVES):
                s, res = solve(generator.row(mix, k + i),
                               getattr(solver, inst))
                instrumented.append({"stage_timings": res.stage_timings,
                                     "loop_s": s.loop_s, "iters": s.iters})
                solved.append((s.row, res.solution))

    meta = solver.meta
    plan = getattr(solver, "_plan", {})
    inv = plan.get("factor_inv")
    shapes = dict(S=meta.num_subdomains, R_int=meta.max_interior,
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

    # --- the check, once the program is freed -------------------------------
    limit = float(cfg["guarantee"]["relative_residual"])
    chk = check.check_solves(A, requests, solved, limit)
    _report_residuals(chk["residuals"], solves, requests)

    ctx = Readings(cell=workload, config=cfg, traffic=mix,
                   platform="gpu" if cuda else "cpu", setup_s=setup_s,
                   setup_split=split, window_s=window_s, solves=solves,
                   counters=counters, shapes=shapes, tables=tables,
                   profile=profile, instrumented=instrumented)
    metrics = {}
    for m in registry.cell_metrics(bench, workload, trace):
        v = registry.reader(root, m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": chk["failed"] == 0 and chk["checked"] > 0,
              "attempted": chk["checked"], "failed": chk["failed"],
              "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, (_, s) in sorted(
                profile["kernels"].items(), key=lambda kv: -kv[1][1])][:TOP],
            "idle_gaps": [[n[:160], s] for n, s in sorted(
                profile["idle_by_host"].items(), key=lambda kv: -kv[1])][:TOP]}
    checks = {"rel_residual_max": {"value": chk["rel_residual_max"],
                                   "limit": limit}}
    result["checks"] = checks
    _report(workload, seed, setup_s, split, solves, window_s, counters, peak,
            card, profile, instrumented)
    return {"result": result, "checks": checks}


def _report(workload, seed, setup_s, split, solves, window_s, counters, peak,
            card, profile, instrumented) -> None:
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
    found = forbidden_modules()
    if found:
        print(f"[portbench] no result: JAX or the JAX package was loaded: "
              f"{found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
