#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``schwarz_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from ``schwarz_tpu_torch/csrc``;
3. holds each kernel (K1 DIA SpMV in float32 and float64, K2 halo-run copy,
   K3 fused CG) to its plain PyTorch version on the card, at the shapes of
   the 1M-row slice, and times kernel, plain version and (K1) one
   ``torch.sparse.mm`` on the same operator in CSR;
4. runs the slice: the 1M-row 2-D Laplacian, 16 regular strips, overlap 3,
   float32, DIA operator, fused Jacobi-CG locals, with every launch count
   set to 0 before and read after; each kernel must have launched;
5. runs the same solve on the CPU (plain versions) for 5 outer iterations
   and requires the global residual history to match within rtol 1e-3;
6. runs default Settings() (float64, unfused CG: K1 float64 + K2) on a 256^2
   Laplacian, 4 subdomains, 20 iterations, on the card and on the CPU, and
   requires them to match within rtol 1e-8;
7. prints one JSON line describing the kernels, then the fixed last line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line, as does a machine
without a CUDA device or a directory without the package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12,  # H100 SXM, outside the tensor cores
                  "float64": 34e12}
SPIN_CYCLES = 4_000_000              # ~2 ms of a spinning kernel


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.kernels = {}
        flush_elems = 128 * 2**20 // 4          # 128 MB > the 50 MB L2
        self._flush = torch.empty(flush_elems, dtype=torch.float32,
                                  device="cuda")

    def check(self, ok: bool, what: str) -> None:
        print(f"{'PASS' if ok else 'FAIL'}: {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def ms(self, fn, reps: int) -> float:
        """Mean device time of ``fn`` from CUDA events around each call,
        with the L2 cache flushed before each (the solve loop reaches every
        kernel with a cold cache: the others stream more than 50 MB).  A
        spin kernel ahead of the first event keeps the card busy while the
        host enqueues ``fn``, so the wrapper's host time is not counted
        (unless ``fn`` itself waits for the card, as the plain CG does)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self._flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps


def kernel_checks(sm: Smoke, solver) -> None:
    """Phase 3: each kernel against its plain version at the slice's
    shapes, then timed beside its bound, its plain version and (K1) a
    library call."""
    import numpy as np
    import torch

    from schwarz_tpu_torch.ops.dia_kernel import dia_spmv, dia_spmv_plain
    from schwarz_tpu_torch.ops.fused_cg import (fused_cg_solve,
                                                fused_cg_solve_plain)
    from schwarz_tpu_torch.ops.halo_kernel import (assemble_runs,
                                                   assemble_runs_plain)
    from schwarz_tpu_torch.parallel.exchange import window_insert

    plan, meta = solver._plan, solver.meta
    S, R_int, R_rows, R_ext = (meta.num_subdomains, meta.max_interior,
                               meta.max_rows, meta.max_ext)
    offsets = solver._dia_offsets
    K = len(offsets)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # --- K1: DIA SpMV, float32 and float64 ----------------------------------
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        dia = plan["dia_vals"].to(dt)
        x_ext = torch.randn((S, R_ext), generator=gen, device="cuda",
                            dtype=dt)
        x = x_ext[:, :R_rows]             # the solver's strided view
        y = dia_spmv(offsets, dia, x)
        torch.cuda.synchronize()
        ref = dia_spmv_plain(offsets, dia, x)
        err = float((y - ref).abs().max())
        tol = (1e-5 if dt == torch.float32 else 1e-12) * float(
            ref.abs().max())
        sm.check(err <= tol, f"K1 dia_spmv {name}: max abs err {err:.3e} "
                 f"<= {tol:.3e} (FMA contraction and sum order)")
        # the same operator as one block-diagonal CSR matrix: the library
        # yardstick (cuSPARSE through torch.sparse.mm), never on the path
        d_np = dia.cpu().numpy()
        rows, cols, vals = [], [], []
        r = np.arange(R_rows)
        for k, o in enumerate(offsets):
            ok = (r + o >= 0) & (r + o < R_rows)
            for s in range(S):
                keep = ok & (d_np[s, k] != 0)
                rows.append(s * R_rows + r[keep])
                cols.append(s * R_rows + r[keep] + o)
                vals.append(d_np[s, k, keep])
        rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
        order = np.lexsort((cols, rows))
        n = S * R_rows
        crow = np.zeros(n + 1, np.int64)
        np.add.at(crow, rows + 1, 1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # "beta" notices
            csr = torch.sparse_csr_tensor(
                torch.from_numpy(np.cumsum(crow)),
                torch.from_numpy(cols[order]), torch.from_numpy(vals[order]),
                size=(n, n)).to("cuda")
        xc = x.contiguous().reshape(n, 1)
        lib_err = float((torch.sparse.mm(csr, xc).reshape(S, R_rows)
                         - ref).abs().max())
        sm.check(lib_err <= tol, f"K1 library yardstick agrees ({lib_err:.3e})")
        e = dia.element_size()
        bound, by = _bound_ms((S * K * R_rows + 2 * S * R_rows) * e,
                              2 * K * S * R_rows, name)
        sm.kernels[f"dia_spmv_{name}"] = dict(
            max_abs_err=err,
            ms=sm.ms(lambda: dia_spmv(offsets, dia, x), 50),
            plain_ms=sm.ms(lambda: dia_spmv_plain(offsets, dia, x), 10),
            bound_ms=bound, bound_by=by,
            library_ms=sm.ms(lambda: torch.sparse.mm(csr, xc), 50))

    # --- K2: halo-run copy ---------------------------------------------------
    x_own = torch.randn((S, R_int), generator=gen, device="cuda")
    tables = (plan["runs_src"], plan["runs_dst"], plan["runs_len"])
    buf = window_insert(x_own, plan["interior_off"], R_ext)
    ref = assemble_runs_plain(buf.clone(), x_own.reshape(-1), *tables, R_ext)
    assemble_runs(buf, x_own.reshape(-1), *tables, R_ext)
    torch.cuda.synchronize()
    err = float((buf - ref).abs().max())
    sm.check(bool(torch.equal(buf, ref)),
             f"K2 assemble_runs bit-identical (max abs err {err})")
    used = plan["runs_dst"] < R_ext
    moved = int((used.to(torch.int64) * plan["runs_len"][None, :]).sum())
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    bound, by = _bound_ms(2 * moved * 4 + table_bytes, 0, "float32")
    xf = x_own.reshape(-1)
    sm.kernels["halo_runs"] = dict(
        max_abs_err=err,
        ms=sm.ms(lambda: assemble_runs(buf, xf, *tables, R_ext), 50),
        plain_ms=sm.ms(lambda: assemble_runs_plain(buf, xf, *tables, R_ext),
                       5),
        bound_ms=bound, bound_by=by, library_ms=None)

    # --- K3: fused CG --------------------------------------------------------
    s = solver.settings
    dia = plan["dia_vals"]
    b = plan["local_rhs"]
    x0 = torch.zeros_like(b)
    dinv = plan["precond_dinv"]
    args = (offsets, dia, b, x0, dinv, s.local_tolerance, s.local_max_iters)
    got = fused_cg_solve(*args)
    torch.cuda.synchronize()
    ref = fused_cg_solve_plain(*args)
    err = float((got.x - ref.x).abs().max())
    tol = 1e-3 * float(ref.x.abs().max())
    d_it = int((got.iters - ref.iters).abs().max())
    sm.check(err <= tol and d_it <= 1,
             f"K3 fused_cg_solve: max abs err {err:.3e} <= {tol:.3e}, "
             f"iterations within {d_it} <= 1 (float32 sums in another order)")
    iters = got.iters.to(torch.int64)
    n_ops = float(((iters * (2 * K + 13)).sum() + S * (2 * K + 6)) * R_rows)
    bound, by = _bound_ms((S * K * R_rows + 4 * S * R_rows) * 4 + S * 8,
                          n_ops, "float32")
    sm.kernels["fused_cg"] = dict(
        max_abs_err=err, ms=sm.ms(lambda: fused_cg_solve(*args), 5),
        plain_ms=sm.ms(lambda: fused_cg_solve_plain(*args), 2),
        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"K3 iterations per subdomain: {got.iters.tolist()}")
    for k, v in sm.kernels.items():
        print(f"{k}: ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
              f"bound_ms={v['bound_ms']:.4f} ({v['bound_by']}) "
              f"library_ms={v['library_ms']}", flush=True)


def _counters():
    from schwarz_tpu_torch.ops.dia_kernel import dia_spmv
    from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve
    from schwarz_tpu_torch.ops.halo_kernel import assemble_runs

    return {"dia_spmv": dia_spmv, "halo_runs": assemble_runs,
            "fused_cg": fused_cg_solve}


def counted_run(solver):
    """Run a solve with every launch count set to 0 just before; return the
    result and the counts read just after."""
    import torch

    fns = _counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    res = solver.run()
    torch.cuda.synchronize()
    return res, {k: f.launches for k, f in fns.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import numpy as np

        from schwarz_tpu_torch import Precond, RASolver, Settings
        from schwarz_tpu_torch.core.decompose import decompose
        from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
        from schwarz_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    card = _card_line()
    print(card, flush=True)
    sm = Smoke(torch)

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built {len(cuda_build.KERNEL_SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # --- the slice's setup ---------------------------------------------------
    t0 = time.perf_counter()
    A = laplacian_2d(1024)
    b = generate_rhs(A.n, random=False)
    settings = Settings(
        overlap=3, dtype="float32", row_pad_multiple=1024, spmv_format="dia",
        fused_local_cg=True, precond=Precond.jacobi, local_tolerance=1e-6,
        local_max_iters=50, tolerance=1e-6, max_iters=30)
    dec = decompose(A, b, settings, 16)
    solver = RASolver(dec)
    torch.cuda.synchronize()
    m = solver.meta
    print(f"setup {time.perf_counter() - t0:.1f} s: N={m.global_size} "
          f"S={m.num_subdomains} R_int={m.max_interior} R_rows={m.max_rows} "
          f"R_ext={m.max_ext} offsets={solver._dia_offsets} "
          f"remainder={solver._dia_has_remainder}", flush=True)

    # --- 3. kernels against their plain versions -----------------------------
    kernel_checks(sm, solver)

    # --- 4. the 1M-row slice on the card -------------------------------------
    res, launches = counted_run(solver)
    n_it = len(res.global_resnorm_history)
    print(f"slice: {n_it} outer iterations, converged={res.converged}, "
          f"wall {res.solve_time_s:.3f} s "
          f"({1e3 * res.solve_time_s / max(n_it, 1):.2f} ms/iteration), "
          f"true relative residual (float64, host) "
          f"{res.relative_residual_norm:.6e}", flush=True)
    print("global residual history: " + " ".join(
        f"{v:.6e}" for v in res.global_resnorm_history), flush=True)
    print(f"launches in the slice: {launches}", flush=True)
    for k, n in launches.items():
        sm.check(n > 0, f"{k} launched {n} times on the main path")
    hist = res.global_resnorm_history
    sm.check(res.solution.shape == (A.n,) and bool(np.isfinite(
        res.solution).all()) and bool(np.isfinite(hist).all()),
        "slice solution and histories finite, solution shape (N,)")
    # this configuration is not expected to converge: solution-form RAS
    # with 50-iteration local CG grows the residual (the port matches the
    # JAX package on a 256^2 analog, tests/test_torch_ras.py); correctness
    # is the agreement with the CPU run below
    sm.check(bool(np.isfinite(res.relative_residual_norm)),
             f"true relative residual finite "
             f"({res.relative_residual_norm:.6e})")
    # the first run pays the one-time loading of PyTorch's own kernels; a
    # second run of the same solver shows the steady per-iteration time
    warm = solver.run()
    print(f"slice again (warm): wall {warm.solve_time_s:.3f} s "
          f"({1e3 * warm.solve_time_s / max(n_it, 1):.2f} ms/iteration)",
          flush=True)
    sm.kernels["dia_spmv_float32"]["launches"] = launches["dia_spmv"]
    sm.kernels["halo_runs"]["launches"] = launches["halo_runs"]
    sm.kernels["fused_cg"]["launches"] = launches["fused_cg"]

    # where the card's time goes in two outer iterations of the slice
    from torch.profiler import ProfilerActivity, profile

    short = RASolver(dataclasses.replace(
        dec, settings=settings.replace(max_iters=2)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        short.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"profile, 2 outer iterations: wall {wall * 1e3:.2f} ms, device "
          f"busy {dev_us / 1e3:.2f} ms", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:70]}", flush=True)

    # --- 5. the same solve on the CPU, 5 outer iterations --------------------
    t0 = time.perf_counter()
    cpu = RASolver(dataclasses.replace(
        dec, settings=settings.replace(max_iters=5)), device="cpu").run()
    h_cpu = cpu.global_resnorm_history
    rel = np.abs(hist[:5] / h_cpu - 1).max()
    sm.check(len(h_cpu) == 5 and rel <= 1e-3,
             f"card vs CPU, first 5 global residuals: max rel diff "
             f"{rel:.3e} <= 1e-3 (float32 sums in another order); CPU took "
             f"{time.perf_counter() - t0:.1f} s")

    # --- 6. default Settings(): float64, unfused CG ---------------------------
    A2 = laplacian_2d(256)
    b2 = generate_rhs(A2.n, random=False)
    dec2 = decompose(A2, b2, Settings(max_iters=20), 4)
    res2, launches2 = counted_run(RASolver(dec2))
    print(f"default f64 (256^2, S=4): {len(res2.global_resnorm_history)} "
          f"iterations, wall {res2.solve_time_s:.3f} s, launches "
          f"{launches2}", flush=True)
    sm.check(launches2["dia_spmv"] > 0 and launches2["halo_runs"] > 0,
             "default Settings() path launched K1 float64 and K2")
    cpu2 = RASolver(dec2, device="cpu").run()
    same_it = res2.iters == cpu2.iters
    rel2 = np.abs(res2.global_resnorm_history
                  / cpu2.global_resnorm_history - 1).max() if same_it else 1.0
    sm.check(same_it and rel2 <= 1e-8,
             f"default f64 card vs CPU: iterations {res2.iters} / "
             f"{cpu2.iters}, max rel diff {rel2:.3e} <= 1e-8")
    sm.kernels["dia_spmv_float64"]["launches"] = launches2["dia_spmv"]

    # --- 7. the kernels line and the last line -------------------------------
    meta_k = {
        "dia_spmv_float32": ("csrc/dia_spmv.cu",
                             "schwarz_tpu/ops/pallas_kernels.py:110"),
        "dia_spmv_float64": ("csrc/dia_spmv.cu",
                             "schwarz_tpu/ops/pallas_kernels.py:110"),
        "halo_runs": ("csrc/halo_runs.cu", "schwarz_tpu/ops/halo_pallas.py:142"),
        "fused_cg": ("csrc/fused_cg.cu", "schwarz_tpu/ops/fused_cg.py:84"),
    }
    line = []
    for name, (src, replaces) in meta_k.items():
        k = sm.kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"schwarz_tpu_torch/{src}", "replaces": replaces,
            "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} phase(s) failed: "
              + "; ".join(sm.failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
