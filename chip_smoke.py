#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``schwarz_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from ``schwarz_tpu_torch/csrc``;
3. holds each kernel (K1 DIA SpMV in float32 and float64, K2 the whole
   ``x_ext`` from its segment table, with float32, bfloat16 and float16
   halos, K3 fused CG) to its plain PyTorch version on the card, at the
   shapes of the 1M-row slice, and times kernel, plain version and one
   library call for the same function (the L2 cache flushed by a 128 MB
   read before each timed call; K1 ``torch.sparse.mm`` on the
   operator in CSR, K2 ``torch.take`` through an index map); K3 at the
   cluster size its wrapper chooses and at one block per subdomain, with
   the variant (vectors in shared or in device memory) each took;
4. runs the slice: the 1M-row 2-D Laplacian, 16 regular strips, overlap 3,
   float32, DIA operator, fused Jacobi-CG locals, with every launch count
   set to 0 before and read after; each kernel must have launched, K2 once
   per outer iteration; then counts with the profiler the device
   operations of one exchange, which must be 1 (K2) on ``all_gather``,
   with and without a bfloat16 halo, and 2 (K4, then K2) on ``rdma``, and
   times each exchange on the card and on the host;
5. runs the same solve on the CPU (plain versions) for 5 outer iterations
   and requires the global residual history to match within rtol 1e-3;
6. runs default Settings() (float64, unfused CG: K1 float64 + K2) on a 256^2
   Laplacian, 4 subdomains, 20 iterations, on the card and on the CPU, and
   requires them to match within rtol 1e-8;
7. holds K8 (x * 2; its time and that of ``x * 2`` the medians of seven
   alternating reads), K9 (the flag-order probe, 10^4 rounds, producer and
   consumer each a cluster of C blocks, at the largest C the card holds two
   of and at C = 1, with every block's SM id) and K5 (the free-running
   rounds, one 16-round launch at the shapes of the 1M-row free-running
   slice) to their plain versions, timed like phase 3; K5 at the cluster
   size its wrapper chooses and at one block per rank;
8. runs the diagnostics path (``python -m schwarz_tpu_torch.diagnostics
   smoke flagorder``) with K8 and K9 counted;
9. runs the free-running slice: ``solve`` on ``laplacian_3d(100)`` (10^6
   rows), 16 subdomains, overlap 2, staleness 1, 16 inner CG iterations,
   float32, 64 rounds, twice (cold, warm), with K5 counted;
10. runs a converging free-running solve, ``laplacian_2d(64)``, 8 ranks, on
   the card and on the CPU: equal ``done_at``, true residual < 1e-3; then
   ``fresh_read`` at staleness 3 (its cluster size covered by phase 7's
   probe) and ``run_refined`` to 1e-8 on the card;
11. holds K6 (the 2-D block-grid rounds) to its plain version: one
   16-round launch at the shapes of the 2-D slice (16 ranks, 272 x 384
   tiles), at the cluster size its wrapper chooses and at one block per
   rank, timed like phase 3, then three small variants (16 blocks folded
   onto 4 ranks, staleness 2, the 9-point anisotropic operator with O-RAS);
12. runs the 2-D free-running slice: ``solve`` on ``laplacian_2d(1024)``
   (10^6 rows), 16 subdomains as 4 x 4 blocks, overlap 2, staleness 1, 16
   inner CG iterations, float32, 64 rounds, twice (cold, warm), with K6
   counted and K5 required to stay at 0;
13. runs a converging 2-D solve, ``laplacian_2d(256)``, 4 x 2 blocks on 8
   ranks, on the card and on the CPU: equal ``done_at``, unequal across
   ranks, true residual < 1e-2, error against a direct solve < 5e-3; then
   ``fresh_read`` at staleness 3 (its cluster size covered by phase 7's
   probe) and ``run_refined`` to 1e-8 on the card;
14. holds K7 (the general-graph rounds) to its plain version: one 16-round
   launch at the shapes of the general slice (128 ranks, one per part of a
   metis partition of a 129 600-row 9-point anisotropic operator), at the
   variant its size takes (a rank's data in shared memory) and with its
   data forced into device memory, both timed like phase 3 (the chosen
   one also with no inner iterations, the rounds' messages and residual
   alone), then three small variants
   (``ani4_crop`` on 8 ranks at staleness 2, a 64^2 Laplacian on 16 ranks
   with O-RAS, 64^2 advection on 8 ranks with BiCGStab), each bit for bit;
15. runs the general free-running slice: ``solve`` on
   ``anisotropic_diffusion_2d(360, eps=5.0, theta=0.3)``, metis partition,
   128 subdomains, overlap 2, staleness 1, 16 inner CG iterations, float32,
   64 rounds, twice (cold, warm), with K7 counted (its variant and threads
   a block printed) and K5 and K6 required to stay at 0;
16. runs a converging general solve, ``ani3_crop.mtx``, metis, 4 ranks, on
   the card and on the CPU: equal ``done_at`` and solution, true residual
   < 5e-3; then ``run_refined`` to 1e-8 on a 64^2 Laplacian, metis, 8
   ranks, and ``ani4_crop.mtx``, metis, 8 ranks, in band;
17. holds K4 (the one-sided neighbour exchange) to its plain version in
   its five variants (put, get, put one by one with flush-all and
   flush-local, get one by one with flush-local): first its one-round case,
   the cyclic shift of a whole buffer (16 ranks, 3072 elements, float32 and
   float64, then 2 and 64 ranks and a ragged small buffer; data bit for
   bit, counters equal), then one whole exchange of the rdma slice (its 2
   rounds of 16 x 3072, pack and unpack in the launch; float32 and
   bfloat16 halos; halo values bit for bit, per-round counts equal), and
   K2 over the halo values it delivers (the neighbour strategies' form of
   K2), bit for bit against its plain version and timed; the exchange
   timed like phase 3 beside two ``torch.roll``, the ``ppermute``
   transport's exchange and the first version's path (two one-round
   launches between the torch pack and unpack);
18. runs the synchronous slice of phase 4 with the strategy switched to
   ``rdma`` (put mode, 16 ranks), 30 outer iterations, twice (cold, warm):
   K4 and K2 must launch once per exchange (outer iteration), K1 and K3
   must launch, and the global residual history must equal phase 4's bit
   for bit;
19. runs converging solves on a second partition, ``laplacian_2d(32)``,
   ``regular2d``, 64 subdomains on 16 ranks, overlap 2, float64, tolerance
   1e-6, on the card and on the CPU: ``rdma`` in get mode (equal iteration
   counts, histories within rtol 1e-8, true residual < 1e-5, the
   ``all_gather`` run's count), then ``overlap_comm``, onesided staleness
   3, ``halo_dtype='float32'`` (tolerance 1e-4), and the ``tree``,
   ``decentralized`` and accumulate convergence protocols, each with equal
   counts on card and CPU and no fewer iterations than the plain run, and
   ``halo_dtype='bfloat16'`` (tolerance 0.25, histories within rtol 1e-2);
20. runs the flagship recipe (``bench.py:531-539``): ``laplacian_2d(512)``,
   16 regular strips, overlap 6, tolerance 1e-8, a float64 outer loop with
   float32 FSAI(0)-preconditioned local CG capped at 20 iterations and the
   two-level spectral coarse space (q = 32), through ``RASolver`` on the
   card (the host setup timed: decompose, the 16 eigensolves into a cache
   under ``build/coarse_cache``, the plan), cold and warm, with K1, K2 and
   K3 counted (K1 per operand, checked against the inner iteration
   history: the float64 operator twice an outer iteration and once on the
   exit pass, the float32 operator and the chained FSAI apply G^T (G r)
   once per inner CG step) and one warm run profiled; then the second rhs of ``bench.py:550-556``
   (``generate_rhs(n, seed=7)``) through ``set_rhs`` on the same solver,
   which must converge in the iterations of a fresh card solver on that
   rhs with its history within rtol 1e-10; then the same recipe on the CPU
   (the basis read from the cache): converged to a true relative residual
   <= 1e-8 in the CPU run's iteration count, both histories printed;
21. holds K1 to its plain version at the flagship's shapes (the float64
   and float32 operator, K = 5, and FSAI's G and G^T, K = 3, all
   (16, ., 21504)), timed like phase 3 beside ``torch.sparse.mm``; the
   chained apply G^T (G r) bit for bit against two K1 launches and within
   1e-5 of its plain version, timed beside two ``torch.sparse.mm`` calls
   and one on the CSR of G^T G formed on the host; K1 and K8 timed once
   more after a 128 MB ``zero_`` (an L2 full of dirty lines) beside the
   read flush; the host us of a ``dia_spmv`` and a ``dia_spmv_chain`` call
   over 1000 calls, with the wrapper's per-operand cache and with it
   cleared before every call;
22. holds K3 to its plain version on the O-RAS operator of a converging
   run (``laplacian_2d(128)``, 16 strips, overlap 6, ``oras_weight=
   'auto'``, float32 Jacobi locals under a float64 outer loop), then runs
   it on the card and on the CPU (iterations within one, histories within
   1e-3, K3 once per local solve);
23. runs two-level free-running refinement (``run_refined(tol=1e-8,
   coarse_q=4)``, ``laplacian_2d(64)``, 8 ranks, the 1-D tier) on the card
   and on the CPU: the same restarts and residual; then the same recipe
   through ``solve(free_running=True, two_level=True)``;
24. runs the reference's campaign configuration (``BASELINE.md``,
   ``run_script:6-56``) at full width: ``laplacian_2d(512)``, METIS into 16
   parts through the native setup library, overlap 8, float64, GMRES
   locals (restart 40, local tolerance 0.1, at most 70 iterations) with
   block-Jacobi, decentralized detection, tolerance 1e-8, 30 outer
   iterations (it does not converge in 30), on the card against the CPU
   run of the same partition (equal inner iteration counts, histories
   within rtol 1e-8 plus 1e-12 of the largest entry), with K1 and K2
   counted and each held to its plain version at the configuration's
   shapes; then the same settings at 128^2 to convergence, where the card
   must detect at the CPU run's count.  Each CPU run follows the card run
   it is compared with, so no timing of the card's host shares its cores;
25. runs dense Cholesky locals through the explicit inverse under FGMRES(30)
   at full width: ``laplacian_2d(512)``, 8 x 8 blocks, overlap 4, float64,
   tolerance 1e-8, reporting the factor's and the inverse's seconds, the
   peak device memory, the iterations and one preconditioner apply beside
   its bound (the 12.76 GB inverse read once), with K1 and K2 counted and
   held to their plain versions; converged to <= 1e-8.  Then at 128^2 on
   4 x 4 blocks: the card's FGMRES run against the CPU's (equal counts,
   histories within the float64 bar), and the stationary ``inverse``,
   ``trisolve``, ``blocked``, LU and ``inverse`` with ``overlap_split``,
   each with the stationary inverse run's count and history;
26. stops a stationary run and an FGMRES(10) run of that 128^2
   configuration after 10 iterations with ``checkpoint_path``, resumes
   each, and requires the uninterrupted runs' histories and solutions bit
   for bit;
27. partitions and decomposes the general slice's operator
   (``anisotropic_diffusion_2d(360)``, METIS into 128 parts, overlap 2)
   with the native setup library and with the Python loops: bit-identical,
   both timed on the card's host;
28. runs ``python -m schwarz_tpu_torch`` in a subprocess, in a temporary
   directory, on the flagship recipe through its flags (``--instrument
   --timings_file t.csv --write_iters_and_residuals --write_comm_data
   --baseline_direct``; the bases read from phase 20's cache): exit code 0,
   converged to <= 1e-8, the seven stage rows in ``t.csv``, sixteen
   ``iter_res_XX.csv`` of one row per pass and a ``comm_data.csv``; prints
   the per-stage split of the outer iteration; then ``RASolver.run()`` in
   this process on ``settings_from_args`` of the same argv must take the
   CLI's iteration count, K1 and K2 counted;
29. runs ``run_instrumented`` and ``run()`` on the slice of phase 3 for 5
   outer iterations (histories within 1e-6 relative), with the launches of
   each stage counted: K2 once per ``boundary_exchange``, K1 in each
   ``convergence_check``, K3 once per ``local_solve``; then
   ``run_accelerated(instrument=True)`` at phase 25's 128^2 size;
30. runs the CLI in this process (its output captured): ``--free_running``
   on phase 10's configuration on 8 ranks (the 2-D tier, K6) and on 7 (the
   1-D tier, K5), and ``--comm_strategy rdma --fused_local_cg --dtype
   float32 --profile_dir`` on a converging 32^2 problem, whose Chrome trace
   must name K4, K2 and K3; then ``gather_values`` / ``scatter_values`` on
   the card against the CPU, and ``native_probe`` of K2 against its plain
   version;
31. runs the synchronous solve across processes (``parallel/mesh.py``): this
   script started again as child processes (``--mesh-child``) on the one
   card, joined in a gloo group on localhost, their CUDA tensors staged
   through pinned host memory, the kernels already built by this process.
   (a) the flagship recipe of phase 20 on 2 processes of 8 strips each (16
   ranks): 18 iterations, true relative residual <= 1e-8, every process the
   same result, its history against phase 20's card history, K1 and K2
   launched in each process at phase 20's rate (2 residuals and 2 (n + 1)
   inner launches, the operator and the chained FSAI apply, an outer
   iteration of n inner iterations, K2 twice); (b)
   the configuration of ``tests/distributed_worker.py`` on 4 processes of 4
   subdomains (16 ranks): the ``neighbor`` strategy, float64, overlap 3,
   tolerance 1e-7, one-level at 64^2, two-level spectral (q = 2, the CG
   coarse solve) at 64^2 and at 256^2, and two-level at 64^2 with float32
   locals through K3 (counted in each process), each at the iteration count
   of this process's single-process card run of the same Settings, below
   1e-5, the two-level count no more than the one-level one; each
   process's warm ms
   per outer iteration and the host ms of its cross-process traffic are
   printed; then ``python -m schwarz_tpu_torch.examples.poisson_basic``'s
   ``main`` on the card (converged, K1 and K2 counted);
32. runs the one-sided exchange across 2 processes on the one card (one
   child group for phases 32-34, ``--mesh-child async``; each process
   launches K4-K7 for its own ranks and reaches the other's through the
   CUDA IPC window of ``Mesh.window``): phase 18's slice (1M rows, 16 ranks,
   30 outer iterations) on ``rdma`` put, K4 and K2 launched once per
   exchange in each process, its history equal to the same 2-process run
   on ``neighbor`` bit for bit; K4's ms per exchange beside phase 17's and
   the longest cross-process wait; then phase 19's get-mode case
   (``laplacian_2d(32)``, ``regular2d``, 64 subdomains on 16 ranks) at
   phase 19's iteration count; it prints the card's compute mode and
   whether the Multi-Process Service runs;
33. runs the free-running tiers across the 2 processes: phase 10's 1-D,
   phase 13's 2-D and phase 16's general solves with ``done_at`` and x
   equal to the single-process card runs' bit for bit, ``run_refined`` to
   1e-8 on the 1-D tier, and phases 9, 12 and 15's slices at full size,
   cold and warm, each tier's kernel counted in each process and the other
   tiers' at 0, each process's solution within ``SLICE_X_RTOL`` of the
   single-process slice's on the same inputs, with the ms per 16-round
   launch, the cluster choice per process and the longest wait;
34. stops the flagship on the 2 processes at 9 iterations with a
   checkpoint and resumes it on 2 processes and in this one: 18
   iterations, the history of phase 31's 2-process run within
   ``MESH_HISTORY_RTOL``; then a free-running 1-D checkpoint across
   processes resumes to the straight run;
35. prints one JSON line describing the kernels (K4-K7 with their launch
   counts and ms per launch in each of the 2 processes), then the fixed
   last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line, as does a machine
without a CUDA device, a directory without the package, or a host where the
native setup library does not build.
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
# the synchronous slice of phases 3-4 (with Jacobi locals), 1M rows
SLICE = dict(overlap=3, dtype="float32", row_pad_multiple=1024,
             spmv_format="dia", fused_local_cg=True, local_tolerance=1e-6,
             local_max_iters=50, tolerance=1e-6, max_iters=30)
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


def _k2_bound(segs, first, S: int, r_ext: int, one_source: bool,
              itemsize: int = 4):
    """K2's bound: x_ext (S, r_ext) written once, the tables read once, and
    each source element that a window or halo segment reads counted once,
    however many segments read it (``itemsize`` bytes a value).  With
    ``one_source`` (the ``all_gather`` form) window and halo segments read
    the same array, ``x_own`` flat; otherwise the halo segments read the
    compact halo values, a second array."""
    import numpy as np

    from schwarz_tpu_torch.ops.halo_kernel import HALO, WINDOW

    seg = segs.cpu().numpy().astype(np.int64)
    n_read = 0
    for kinds in ([(WINDOW, HALO)] if one_source else [(WINDOW,), (HALO,)]):
        sel = seg[np.isin(seg[:, 2], kinds)]
        if len(sel):
            ends = sel[:, 3] + sel[:, 1]
            depth = np.zeros(int(ends.max()) + 1, np.int64)
            np.add.at(depth, sel[:, 3], 1)
            np.add.at(depth, ends, -1)
            n_read += int((np.cumsum(depth) > 0).sum())
    table_bytes = (segs.numel() + first.numel()) * 4
    return _bound_ms((S * r_ext + n_read) * itemsize + table_bytes, 0,
                     "float32")


def _k2_take(segs, x_own, r_ext: int):
    """The library yardstick of K2: ``x_ext`` as one ``torch.take`` over
    [x_own flat ; 0] through an (S, r_ext) int64 index map (the zero
    segments point at the 0); returns the call's inputs."""
    import numpy as np
    import torch

    from schwarz_tpu_torch.ops.halo_kernel import ZERO

    S, R_int = x_own.shape
    seg_np = segs.cpu().numpy().astype(np.int64)
    lens = seg_np[:, 1]
    index = np.repeat(np.where(seg_np[:, 2] == ZERO, S * R_int, seg_np[:, 3]),
                      lens) + np.where(
        np.repeat(seg_np[:, 2] == ZERO, lens), 0,
        np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens))
    index = torch.from_numpy(index.reshape(S, r_ext)).cuda()
    return torch.cat((x_own.reshape(-1), x_own.new_zeros(1))), index


def k2_entry(sm, solver, what: str) -> dict:
    """K2 at ``solver``'s segment table and dtype against its plain version
    (bit for bit), then timed beside its bound, its plain version and
    ``torch.take``."""
    import torch

    from schwarz_tpu_torch.ops.halo_kernel import (assemble_x_ext,
                                                   assemble_x_ext_plain)

    m = solver.meta
    S, R_int, R_ext = m.num_subdomains, m.max_interior, m.max_ext
    gen = torch.Generator(device="cuda").manual_seed(2)
    x_own = torch.randn((S, R_int), generator=gen, device="cuda",
                        dtype=solver.settings.value_dtype)
    segs, first = solver._plan["ext_segs"], solver._plan["ext_first"]
    args = (x_own, x_own, segs, first, R_ext)
    got = assemble_x_ext(*args)
    torch.cuda.synchronize()
    ref = assemble_x_ext_plain(*args)
    err = float((got - ref).abs().max())
    src, index = _k2_take(segs, x_own, R_ext)
    sm.check(bool(torch.equal(got, ref))
             and bool(torch.equal(torch.take(src, index), ref)),
             f"K2 {what}, {segs.shape[0]} segments for {S} x {R_ext} "
             f"{str(x_own.dtype).split('.')[-1]} slots: bit-identical to its "
             f"plain version and to torch.take (max abs err {err})")
    bound, by = _k2_bound(segs, first, S, R_ext, True, x_own.element_size())
    return dict(max_abs_err=err, segments=segs.shape[0],
                ms=sm.ms(lambda: assemble_x_ext(*args), 50),
                plain_ms=sm.ms(lambda: assemble_x_ext_plain(*args), 5),
                bound_ms=bound, bound_by=by,
                library_ms=sm.ms(lambda: torch.take(src, index), 50))


def _k3_bound(iters, S: int, K: int, R: int):
    """K3's bound: the operator, b, x0, dinv read once and x written once
    (float32), against the iterations this run's data took, 2K + 13
    operations a row each, plus the set-up pass."""
    n_ops = float(((iters.to("cpu").long() * (2 * K + 13)).sum()
                   + S * (2 * K + 6)) * R)
    return _bound_ms((S * K * R + 4 * S * R) * 4 + S * 8, n_ops, "float32")


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.kernels = {}
        # phase 33 holds its 2-process runs against these single-process
        # ones: the converging solves' (x, info) of phases 10, 13 and 16 and
        # the cold solutions of phases 9, 12 and 15's slices
        self.free_refs = {}
        self.slice_refs = {}
        flush_elems = 128 * 2**20 // 4          # 128 MB > the 50 MB L2
        self._flush = torch.empty(flush_elems, dtype=torch.float32,
                                  device="cuda")

    def check(self, ok: bool, what: str) -> None:
        print(f"{'PASS' if ok else 'FAIL'}: {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def ms(self, fn, reps: int, flush: str = "read") -> float:
        """Mean device time of ``fn`` from CUDA events around each call,
        with the L2 cache flushed before each (the solve loop reaches every
        kernel with a cold cache: the others stream more than 50 MB).  A
        spin kernel ahead of the first event keeps the card busy while the
        host enqueues ``fn``, so the wrapper's host time is not counted
        (unless ``fn`` itself waits for the card, as the plain CG does).
        ``flush``: ``"read"`` sums 128 MB, which leaves L2 clean;
        ``"write"`` zeroes them, which leaves it full of dirty lines whose
        write-back the timed call pays: K1 at the flagship's shapes reads
        15-25% longer so, K8 4% (phase 21 prints both)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            if flush == "write":
                self._flush.zero_()
            else:
                self._flush.sum()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _dia_csr(offsets, dia):
    """The block-diagonal (S R, S R) scipy CSR matrix of a DIA operator
    (S, K, R), entries whose column leaves [0, R) dropped, on the host."""
    import numpy as np
    import scipy.sparse as sp

    S, _, R_rows = dia.shape
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
    n = S * R_rows
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(n, n))


def _torch_csr(m, dtype):
    """A scipy CSR matrix as a torch CSR tensor of ``dtype`` on the card
    (the library yardsticks: cuSPARSE, never on the path)."""
    import torch

    m = m.tocsr()
    m.sort_indices()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notices
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype("int64")),
            torch.from_numpy(m.indices.astype("int64")),
            torch.from_numpy(m.data).to(dtype), size=m.shape).to("cuda")


def k1_entry(sm: Smoke, offsets, dia, x, what: str) -> dict:
    """K1 on ``dia`` (S, K, R) and ``x`` against its plain version, then
    timed beside its bound, its plain version and ``torch.sparse.mm`` on
    the same operator as one block-diagonal CSR matrix (the library
    yardstick: cuSPARSE, never on the path)."""
    import torch

    from schwarz_tpu_torch.ops.dia_kernel import dia_spmv, dia_spmv_plain

    S, K, R_rows = dia.shape
    name = str(dia.dtype).split(".")[-1]
    y = dia_spmv(offsets, dia, x)
    torch.cuda.synchronize()
    ref = dia_spmv_plain(offsets, dia, x)
    err = float((y - ref).abs().max())
    tol = (1e-5 if dia.dtype == torch.float32 else 1e-12) * float(
        ref.abs().max())
    sm.check(err <= tol, f"K1 {what}: max abs err {err:.3e} <= {tol:.3e} "
             f"(FMA contraction and sum order)")
    csr = _torch_csr(_dia_csr(offsets, dia), dia.dtype)
    n = S * R_rows
    xc = x[:, :R_rows].contiguous().reshape(n, 1)
    lib_err = float((torch.sparse.mm(csr, xc).reshape(S, R_rows)
                     - ref).abs().max())
    sm.check(lib_err <= tol, f"K1 {what}: library yardstick agrees "
             f"({lib_err:.3e})")
    e = dia.element_size()
    bound, by = _bound_ms((S * K * R_rows + 2 * S * R_rows) * e,
                          2 * K * S * R_rows, name)
    return dict(
        max_abs_err=err,
        ms=sm.ms(lambda: dia_spmv(offsets, dia, x), 50),
        plain_ms=sm.ms(lambda: dia_spmv_plain(offsets, dia, x), 10),
        bound_ms=bound, bound_by=by,
        library_ms=sm.ms(lambda: torch.sparse.mm(csr, xc), 50))


def chain_entry(sm: Smoke, go, gd, uo, ud, r, what: str) -> dict:
    """K1's chained product z = DIA(uo, ud) (DIA(go, gd) r) bit for bit
    against two K1 launches and within 1e-5 of its plain version, then
    timed beside its bound (both operators, r and z), its plain version,
    the two launches, two ``torch.sparse.mm`` calls, and ``library_ms``:
    one ``torch.sparse.mm`` on the CSR of the product, formed once on the
    host (one PyTorch call computing the same function)."""
    import torch

    from schwarz_tpu_torch.ops.dia_kernel import (default_tile, dia_spmv,
                                                  dia_spmv_chain,
                                                  dia_spmv_chain_plain)

    S, K_in, R = gd.shape
    K_out = ud.shape[1]
    z = dia_spmv_chain(go, gd, uo, ud, r)
    two = dia_spmv(uo, ud, dia_spmv(go, gd, r))
    torch.cuda.synchronize()
    ref = dia_spmv_chain_plain(go, gd, uo, ud, r)
    err = float((z - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    sm.check(bool(torch.equal(z, two)) and err <= tol,
             f"K1 chain {what}: bit-identical to two K1 launches, max abs "
             f"err {err:.3e} <= {tol:.3e} against its plain version")
    g_csr, u_csr = _dia_csr(go, gd), _dia_csr(uo, ud)
    dt = gd.dtype
    product = u_csr.astype("float64") @ g_csr.astype("float64")
    g_t, u_t, p_t = (_torch_csr(m, dt) for m in (g_csr, u_csr, product))
    rc = r[:, :R].contiguous().reshape(S * R, 1)
    lib_err = float((torch.sparse.mm(p_t, rc).reshape(S, R)
                     - ref).abs().max())
    sm.check(lib_err <= tol, f"K1 chain {what}: library yardstick (the CSR "
             f"of the product) agrees ({lib_err:.3e})")
    e = gd.element_size()
    bound, by = _bound_ms(((K_in + K_out) * S * R + 2 * S * R) * e,
                          2 * (K_in + K_out) * S * R,
                          str(dt).split(".")[-1])
    return dict(
        max_abs_err=err, tile=default_tile(S, R, r.device),
        ms=sm.ms(lambda: dia_spmv_chain(go, gd, uo, ud, r), 50),
        plain_ms=sm.ms(lambda: dia_spmv_chain_plain(go, gd, uo, ud, r), 10),
        bound_ms=bound, bound_by=by,
        library_ms=sm.ms(lambda: torch.sparse.mm(p_t, rc), 50),
        two_launches_ms=sm.ms(lambda: dia_spmv(uo, ud, dia_spmv(go, gd, r)),
                              50),
        library_two_ms=sm.ms(lambda: torch.sparse.mm(
            u_t, torch.sparse.mm(g_t, rc)), 50))


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds a call of ``fn`` over ``n`` calls back to back,
    no synchronize between them (the card idle before)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def kernel_checks(sm: Smoke, solver) -> None:
    """Phase 3: each kernel against its plain version at the slice's
    shapes, then timed beside its bound, its plain version and (K1) a
    library call."""
    import numpy as np
    import torch

    from schwarz_tpu_torch.ops.fused_cg import (fused_cg_solve,
                                                fused_cg_solve_plain)
    from schwarz_tpu_torch.ops.halo_kernel import (assemble_x_ext,
                                                   assemble_x_ext_plain)

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
        # the solver's strided view
        sm.kernels[f"dia_spmv_{name}"] = k1_entry(
            sm, offsets, dia, x_ext[:, :R_rows], f"dia_spmv {name}")

    # --- K2: the whole x_ext in one launch ----------------------------------
    x_own = torch.randn((S, R_int), generator=gen, device="cuda")
    segs, first = plan["ext_segs"], plan["ext_first"]
    args = (x_own, x_own, segs, first, R_ext)
    for hd in (None, torch.bfloat16, torch.float16):
        got = assemble_x_ext(*args, hd)
        torch.cuda.synchronize()
        ref = assemble_x_ext_plain(*args, hd)
        e = float((got - ref).abs().max())
        sm.check(bool(torch.equal(got, ref)),
                 f"K2 assemble_x_ext, halo "
                 f"{str(hd or x_own.dtype).split('.')[-1]}, {segs.shape[0]} "
                 f"segments: bit-identical (max abs err {e})")
        if hd is None:
            err, out = e, got
    bound, by = _k2_bound(segs, first, S, R_ext, True)
    src, index = _k2_take(segs, x_own, R_ext)
    sm.check(bool(torch.equal(torch.take(src, index), out)),
             "K2 library yardstick (torch.take) agrees bit for bit")
    # the copy rate of the card on as many bytes: one torch copy_ of
    # S x R_ext floats (K2 reads and writes about as much)
    flat = out.reshape(-1)
    dst = torch.empty_like(flat)
    # all times a few microseconds: the median of five alternating reads,
    # each the mean of 50 launches, keeps one host stall longer than the
    # spin kernel from deciding a number
    timed = {
        "ms": lambda: assemble_x_ext(*args),
        "library_ms": lambda: torch.take(src, index),
        "ms_bfloat16": lambda: assemble_x_ext(*args, torch.bfloat16),
        "ms_copy": lambda: dst.copy_(flat)}
    reads = {k: [] for k in timed}
    for _ in range(5):
        for k, fn in timed.items():
            reads[k].append(sm.ms(fn, 50))
    t = {k: float(np.median(v)) for k, v in reads.items()}
    sm.kernels["halo_runs"] = dict(
        max_abs_err=err, segments=segs.shape[0], ms=t["ms"],
        plain_ms=sm.ms(lambda: assemble_x_ext_plain(*args), 5),
        bound_ms=bound, bound_by=by, library_ms=t["library_ms"])
    print(f"K2: {segs.shape[0]} segments for {S} x {R_ext} slots; "
          f"{t['ms']:.5f} ms (reads {reads['ms']}), {t['ms_bfloat16']:.5f} "
          f"with bfloat16 halos; torch.take {t['library_ms']:.5f}; a copy_ "
          f"of {S} x {R_ext} floats {t['ms_copy']:.5f} (medians of 5 "
          f"reads); bound {bound:.6f} ms", flush=True)

    # --- K3: fused CG --------------------------------------------------------
    s = solver.settings
    dia = plan["dia_vals"]
    b = plan["local_rhs"]
    x0 = torch.zeros_like(b)
    dinv = plan["precond_dinv"]
    args = (offsets, dia, b, x0, dinv, s.local_tolerance, s.local_max_iters)
    ref = fused_cg_solve_plain(*args)
    tol = 1e-3 * float(ref.x.abs().max())
    # at the cluster size the wrapper chooses, then on one block per
    # subdomain (the first version's layout), each against the plain version
    res = {}
    for force in (None, 1):
        got = fused_cg_solve(*args, cluster=force)
        torch.cuda.synchronize()
        C, var = fused_cg_solve.cluster, fused_cg_solve.variant
        err = float((got.x - ref.x).abs().max())
        d_it = int((got.iters - ref.iters).abs().max())
        res[force] = (C, var, err, got)
        sm.check(err <= tol and d_it <= 1,
                 f"K3 fused_cg_solve, {C} blocks per subdomain ({var} "
                 f"memory){' (chosen)' if force is None else ''}: max abs "
                 f"err {err:.3e} <= {tol:.3e}, iterations within {d_it} <= 1 "
                 f"(float32 sums in another order)")
    C, var, err, got = res[None]
    bound, by = _k3_bound(got.iters, S, K, R_rows)
    ms1 = sm.ms(lambda: fused_cg_solve(*args, cluster=1), 5)
    sm.kernels["fused_cg"] = dict(
        max_abs_err=err, cluster=C, variant=var,
        ms=sm.ms(lambda: fused_cg_solve(*args), 5),
        plain_ms=sm.ms(lambda: fused_cg_solve_plain(*args), 2),
        bound_ms=bound, bound_by=by, library_ms=None)
    ms1b = sm.ms(lambda: fused_cg_solve(*args, cluster=1), 5)
    sm.kernels["fused_cg"]["ms_one_block"] = (ms1 + ms1b) / 2
    print(f"K3 per launch: {sm.kernels['fused_cg']['ms']:.4f} ms at {C} "
          f"blocks per subdomain ({var} memory, {C * S} of the card's SMs), "
          f"{ms1:.4f} / {ms1b:.4f} ms at 1 block per subdomain "
          f"({res[1][1]} memory; before / after)", flush=True)
    print(f"K3 iterations per subdomain: {got.iters.tolist()}")
    for k, v in sm.kernels.items():
        print(f"{k}: ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
              f"bound_ms={v['bound_ms']:.4f} ({v['bound_by']}) "
              f"library_ms={v['library_ms']}", flush=True)


def async_kernel_checks(sm: Smoke, solver) -> None:
    """Phase 7: K8, K9 and K5 against their plain versions; K5 at the
    shapes of the free-running slice (one 16-round launch from zero)."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import diagnostics as dg
    from schwarz_tpu_torch.ops import cuda_build
    from schwarz_tpu_torch.ops.async_ras_kernel import (
        async_ras_rounds, async_ras_rounds_plain)

    def fits(c):
        return cuda_build.library("async_ras").async_ras_max_clusters(
            len(solver.plan.offsets), c)

    # --- K8: x * 2 -----------------------------------------------------------
    x = torch.randn((256, 256), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    y = dg.smoke_x2(x)
    torch.cuda.synchronize()
    ok = torch.equal(y, dg.smoke_x2_plain(x))
    sm.check(ok, "K8 smoke_x2 bit-identical to x * 2")
    bound, by = _bound_ms(2 * x.numel() * 4, x.numel(), "float32")
    # both are launch floors; the median of alternating reads, each the
    # mean of 50 launches, keeps one slow read from deciding the order
    reads = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(7):
        reads["ms"].append(sm.ms(lambda: dg.smoke_x2(x), 50))
        reads["library_ms"].append(sm.ms(lambda: x * 2, 50))
        reads["plain_ms"].append(sm.ms(lambda: dg.smoke_x2_plain(x), 50))
    sm.kernels["smoke_x2"] = dict(
        max_abs_err=float((y - x * 2).abs().max()),
        **{k: float(np.median(v)) for k, v in reads.items()},
        bound_ms=bound, bound_by=by)
    print(f"K8 reads (ms): kernel {reads['ms']}, x * 2 "
          f"{reads['library_ms']}", flush=True)

    # --- K9: the flag-order probe, at the cluster size it chooses (the
    # largest the card holds two of) and at one block a side ------------------
    n, rounds = 32768, 10000
    res = {}
    for force in (None, 1):
        r = dg.flag_order_probe(n, rounds, "cuda", cluster=force)
        C = r["cluster"]
        sms = r["producer_sms"] + r["consumer_sms"]
        sm.check(r["mismatches"] == 0 and r["error"] == 0
                 and len(set(sms)) == 2 * C,
                 f"K9 flag_order_probe at C = {C}"
                 f"{' (chosen)' if force is None else ''}: {rounds} rounds "
                 f"of {n} floats, {r['mismatches']} mismatches, watchdog "
                 f"{r['error']}, producer SMs {r['producer_sms']}, consumer "
                 f"SMs {r['consumer_sms']} ({len(set(sms))} distinct of "
                 f"{2 * C})")
        res[force] = r
    chosen_c = res[None]["cluster"]
    plain = dg.flag_order_probe_plain(n, rounds, "cuda", cluster=chosen_c)
    bound, by = _bound_ms(2 * rounds * n * 4, 0, "float32")
    sm.kernels["flag_order_probe"] = dict(
        max_abs_err=float(abs(res[None]["mismatches"]
                              - plain["mismatches"])),
        cluster=chosen_c,
        ms=sm.ms(lambda: dg.flag_order_probe(n, rounds, "cuda"), 3),
        ms_one_block=sm.ms(
            lambda: dg.flag_order_probe(n, rounds, "cuda", cluster=1), 3),
        plain_ms=sm.ms(lambda: dg.flag_order_probe_plain(n, rounds, "cuda"),
                       1),
        bound_ms=bound, bound_by=by, library_ms=None)
    k9 = sm.kernels["flag_order_probe"]
    print(f"K9 per probe: {k9['ms']:.4f} ms at C = {chosen_c}, "
          f"{k9['ms_one_block']:.4f} ms at C = 1; passed here up to C = "
          f"{dg.flag_order_passed('cuda')}", flush=True)

    # --- K5: one launch of the free-running slice ----------------------------
    p, d, D = solver.plan, solver._dev, solver.D
    x0, known, aux, hl, hr = solver.init_state()
    args = (d["dia"], d["b"], d["dinv"], d["mask_dom"], d["mask_int"],
            x0.reshape(D, -1), known, aux, hl, hr, d.get("boost"))
    kw = dict(offsets=p.offsets, total=p.total, hw=p.hw,
              rounds=solver.chunk_rounds, staleness=solver.staleness,
              ninner=solver.ninner, tol=solver.tolerance)
    ref = async_ras_rounds_plain(*args, **kw)
    tol = 1e-4 * float(ref[0].abs().max())
    # at the cluster size the wrapper chooses, then at one block per rank
    # (the first version's layout), each against the plain version
    errs = {}
    for force in (None, 1):
        got = async_ras_rounds(*args, **kw, cluster=force)
        torch.cuda.synchronize()
        C = async_ras_rounds.cluster
        err = float((got[0] - ref[0]).abs().max())
        same = (torch.equal(got[1], ref[1]) and torch.equal(got[2][:, :3],
                                                            ref[2][:, :3]))
        errs[C] = err
        sm.check(err <= tol and same,
                 f"K5 async_ras_rounds, {solver.chunk_rounds} rounds at the "
                 f"slice's shapes, {C} blocks per rank"
                 f"{' (chosen)' if force is None else ''}: max abs err "
                 f"{err:.3e} <= {tol:.3e} (float64 sums of the same float32 "
                 f"products: equal up to ties), known bits and done_at "
                 f"equal: {same}")
        if force is None:
            chosen = C
    K, L = d["dia"].shape[1], d["dia"].shape[2]
    rows = D * L
    n_bytes = 4 * (rows * (K + 4) + 2 * p.S * p.R)
    n_ops = solver.chunk_rounds * solver.ninner * (2 * K + 13) * rows
    bound, by = _bound_ms(n_bytes, n_ops, "float32")
    ms1 = sm.ms(lambda: async_ras_rounds(*args, **kw, cluster=1), 3)
    for c in (2, 4, 8):
        if c != chosen and fits(c) >= D:
            t = sm.ms(lambda: async_ras_rounds(*args, **kw, cluster=c), 3)
            print(f"K5 at {c} blocks per rank: {t:.4f} ms per launch",
                  flush=True)
    sm.kernels["async_ras"] = dict(
        max_abs_err=errs[chosen], cluster=chosen,
        ms=sm.ms(lambda: async_ras_rounds(*args, **kw), 3),
        plain_ms=sm.ms(lambda: async_ras_rounds_plain(*args, **kw), 1),
        bound_ms=bound, bound_by=by, library_ms=None)
    ms1b = sm.ms(lambda: async_ras_rounds(*args, **kw, cluster=1), 3)
    sm.kernels["async_ras"]["ms_one_block"] = (ms1 + ms1b) / 2
    print(f"K5 per {solver.chunk_rounds}-round launch: "
          f"{sm.kernels['async_ras']['ms']:.4f} ms at {chosen} blocks per "
          f"rank ({chosen * D} of the card's SMs), {ms1:.4f} / {ms1b:.4f} ms "
          f"at 1 block per rank (before / after); clusters the card holds "
          f"at 8, 4, 2, 1 blocks: {[fits(c) for c in (8, 4, 2, 1)]}",
          flush=True)
    for k in ("smoke_x2", "flag_order_probe", "async_ras"):
        v = sm.kernels[k]
        print(f"{k}: ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
              f"bound_ms={v['bound_ms']:.4f} ({v['bound_by']}) "
              f"library_ms={v['library_ms']}", flush=True)


def _counters():
    from schwarz_tpu_torch import diagnostics as dg
    from schwarz_tpu_torch.ops.async_ras_2d_kernel import async_ras_2d_rounds
    from schwarz_tpu_torch.ops.async_ras_general_kernel import (
        async_general_rounds)
    from schwarz_tpu_torch.ops.async_ras_kernel import async_ras_rounds
    from schwarz_tpu_torch.ops.dia_kernel import dia_spmv
    from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve
    from schwarz_tpu_torch.ops.halo_kernel import assemble_x_ext
    from schwarz_tpu_torch.ops.rdma_kernel import rdma_cyclic_shift

    return {"dia_spmv": dia_spmv, "halo_runs": assemble_x_ext,
            "rdma_shift": rdma_cyclic_shift,
            "fused_cg": fused_cg_solve, "async_ras": async_ras_rounds,
            "async_ras_2d": async_ras_2d_rounds,
            "async_ras_general": async_general_rounds,
            "smoke_x2": dg.smoke_x2, "flag_order_probe": dg.flag_order_probe}


def counted(fn):
    """Call ``fn`` with every launch count set to 0 just before; return its
    result and the counts read just after."""
    import torch

    fns = _counters()
    for f in fns.values():
        f.launches = 0
    fns["dia_spmv"].launches_by = {}
    torch.cuda.synchronize()
    res = fn()
    torch.cuda.synchronize()
    return res, {k: f.launches for k, f in fns.items()}


def exchange_costs(sm: Smoke, cases) -> None:
    """Device operations (kernels, copies, memsets; the profiler's count)
    in one ``solver._exchange`` of each case ``(solver, what, want,
    ms_per_it)``, which must be ``want`` and equal the launches its
    wrappers counted; then its device time (events, L2 flushed) and its
    host time per call, beside a warm outer iteration of ``ms_per_it``
    when one is given.

    The cases share one profiler window.  The profiler keeps only the
    device records that lie inside its window as placed on the host's
    clock, and now and then drops a window's first launches (``PERF.md``
    §7), so each exchange has the card idle and 20 ms on each side; those
    idle gaps split the record into one group per exchange."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from schwarz_tpu_torch.ops.rdma_kernel import rdma_shift_finish

    def finish(solver):
        # K4's status words are read, as at an outer iteration's sync
        torch.cuda.synchronize()
        if solver._pending_shifts:
            rdma_shift_finish(solver._pending_shifts)
            solver._pending_shifts.clear()

    xs = []
    for solver, _, _, _ in cases:
        m = solver.meta
        xs.append(torch.randn((m.num_subdomains, m.max_interior),
                              device="cuda",
                              dtype=solver.settings.value_dtype))
        solver._exchange(xs[-1])
        finish(solver)
    wrapped = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for (solver, _, _, _), x in zip(cases, xs):
            torch.cuda.synchronize()
            time.sleep(0.02)
            _, c = counted(lambda: solver._exchange(x))
            wrapped.append(sum(c.values()))
        time.sleep(0.02)
    for solver, _, _, _ in cases:
        finish(solver)
    groups = []
    for e in sorted((e for e in prof.events()
                     if "CUDA" in str(getattr(e, "device_type", ""))),
                    key=lambda e: e.time_range.start):
        if not groups or e.time_range.start - groups[-1][-1].time_range.end \
                > 10_000:
            groups.append([])
        groups[-1].append(e)
    sm.check(len(groups) == len(cases),
             f"one profiler window of {len(cases)} exchanges, 20 ms apart: "
             f"{len(groups)} group(s) of device operations "
             f"{[[e.name for e in g] for g in groups]}")
    for (solver, what, want, ms_per_it), x, n, g in zip(cases, xs, wrapped,
                                                       groups):
        names = [e.name for e in g]
        sm.check(len(names) == want == n,
                 f"{what}: one exchange is {len(names)} device "
                 f"operation(s) (want {want}; its wrappers counted {n}): "
                 f"{names}")
        ms = sm.ms(lambda: solver._exchange(x), 50)
        finish(solver)
        t0 = time.perf_counter()
        for _ in range(100):
            solver._exchange(x)
        host_ms = (time.perf_counter() - t0) * 10
        finish(solver)
        share = ("" if ms_per_it is None else
                 f", of a warm outer iteration of {ms_per_it:.3f} ms")
        print(f"{what}: exchange {ms:.5f} ms on the card (events), "
              f"{host_ms:.5f} ms of host time per call{share}", flush=True)


def free_running_phases(sm: Smoke) -> None:
    """Phases 7-10: the free-running kernels, the diagnostics path, the
    1M-row free-running slice and a converging solve."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import diagnostics
    from schwarz_tpu_torch.models import laplacian_2d, laplacian_3d
    from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
    from schwarz_tpu_torch.ops.async_ras_kernel import async_ras_rounds
    from schwarz_tpu_torch.ras import make_free_running_solver, solve

    t0 = time.perf_counter()
    A = laplacian_3d(100)
    b = np.ones(A.n)
    settings = _slice_free_settings()
    solver, refine = make_free_running_solver(A, b, 16, settings)
    torch.cuda.synchronize()
    p = solver.plan
    print(f"free-running setup {time.perf_counter() - t0:.1f} s: N={p.N} "
          f"S={p.S} ranks={solver.D} R={p.R} bw={max(p.offsets)} "
          f"ovp={p.ovp} hw={p.hw} total={p.total} K={len(p.offsets)} "
          f"refine={refine}", flush=True)

    # --- 7. K8, K9, K5 against their plain versions --------------------------
    async_kernel_checks(sm, solver)

    # --- 8. the diagnostics path ---------------------------------------------
    rc, launches = counted(lambda: diagnostics.main(["smoke", "flagorder"]))
    print(f"diagnostics path: exit {rc}, launches {launches}", flush=True)
    sm.check(rc == 0, "diagnostics smoke flagorder passed")
    for k in ("smoke_x2", "flag_order_probe"):
        sm.check(launches[k] > 0, f"{k} launched {launches[k]} times on the "
                 "diagnostics path")
        sm.kernels[k]["launches"] = launches[k]

    # --- 9. the 1M-row free-running slice, cold then warm --------------------
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        res, launches = counted(lambda: solve(A, b, settings, 16))
        wall = time.perf_counter() - t0
        n_rounds = launches["async_ras"] * solver.chunk_rounds
        print(f"free-running slice ({tag}): {n_rounds} rounds in "
              f"{launches['async_ras']} launches of "
              f"{async_ras_rounds.cluster} blocks per rank, run loop "
              f"{res.solve_time_s:.4f} s = "
              f"{1e3 * res.solve_time_s / max(n_rounds, 1):.3f} ms/round, "
              f"solve() wall with setup {wall:.2f} s, converged="
              f"{res.converged}, true relative residual "
              f"{res.relative_residual_norm:.6e}",
              flush=True)
        if tag == "cold":
            sm.check(launches["async_ras"] > 0,
                     f"async_ras launched {launches['async_ras']} times on "
                     "the free-running slice")
            sm.kernels["async_ras"]["launches"] = launches["async_ras"]
            sm.check(res.solution.shape == (A.n,) and bool(np.isfinite(
                res.solution).all()) and np.isfinite(
                res.relative_residual_norm)
                and res.relative_residual_norm < 1.0,
                f"free-running slice: finite solution, true relative "
                f"residual {res.relative_residual_norm:.6e} < 1")
            sm.slice_refs["slice_1d"] = res.solution
    k5_ms = sm.kernels["async_ras"]["ms"]
    print(f"where the time goes (warm): K5 {k5_ms:.3f} ms per "
          f"{solver.chunk_rounds}-round launch (events, phase 7) x "
          f"{launches['async_ras']} launches = "
          f"{k5_ms * launches['async_ras']:.3f} ms of a "
          f"{1e3 * res.solve_time_s:.3f} ms run loop", flush=True)
    del solver

    # --- 10. a converging free-running solve: card against CPU ---------------
    A2 = laplacian_2d(64)
    b2 = np.ones(A2.n)
    kw = dict(overlap=2, tolerance=1e-4, staleness=1, ninner=20,
              chunk_rounds=16, num_ranks=8)
    x_c, i_c = AsyncRASolver(A2, b2, 8, **kw).run(max_rounds=800)
    x_h, i_h = AsyncRASolver(A2, b2, 8, device="cpu", **kw).run(
        max_rounds=800)
    print(f"64^2 free-running, 8 ranks of {async_ras_rounds.cluster} blocks: "
          f"card done_at {i_c['done_at'].tolist()} "
          f"in {i_c['rounds']} rounds, {i_c['time_s']:.4f} s, true rel "
          f"{i_c['relative_residual_norm']:.6e}; CPU done_at "
          f"{i_h['done_at'].tolist()}, true rel "
          f"{i_h['relative_residual_norm']:.6e}; max |x_card - x_cpu| "
          f"{np.abs(x_c - x_h).max():.3e}", flush=True)
    sm.check(i_c["converged"] and len(np.unique(i_c["done_at"])) > 1
             and np.array_equal(i_c["done_at"], i_h["done_at"])
             and i_c["relative_residual_norm"] < 1e-3,
             "64^2 free-running converges on the card with unequal done_at "
             "equal to the CPU run's, true residual < 1e-3")
    sm.free_refs["1d"] = (x_c, i_c)         # phase 33 runs it on 2 processes
    covered = diagnostics.flag_order_passed("cuda")
    fr = AsyncRASolver(A2, b2, 8, **{**kw, "staleness": 3},
                       fresh_read=True)
    _, i_f = fr.run(max_rounds=800)
    print(f"fresh_read, staleness 3, ranks of {async_ras_rounds.cluster} "
          f"blocks after a probe that passed at C = {covered}: done_at "
          f"{i_f['done_at'].tolist()}, hits {i_f['fresh_read_hits']}, true "
          f"rel {i_f['relative_residual_norm']:.6e}", flush=True)
    sm.check(i_f["converged"] and i_f["fresh_read_hits"] > 0
             and i_f["relative_residual_norm"] < 1e-3
             and async_ras_rounds.cluster <= covered,
             "fresh_read at staleness 3 converges with hits > 0, its "
             "cluster size covered by the probe")
    xr, i_r = AsyncRASolver(A2, b2, 8, **kw).run_refined(tol=1e-8,
                                                         max_rounds=800)
    print(f"run_refined(tol=1e-8): {i_r['restarts']} restarts, "
          f"{i_r['rounds']} rounds, true rel "
          f"{i_r['relative_residual_norm']:.6e}", flush=True)
    sm.check(i_r["converged"] and i_r["relative_residual_norm"] <= 1e-8,
             "run_refined reaches a true relative residual <= 1e-8")


def _k6_against_plain(sm: Smoke, solver, what: str, cluster=None):
    """One K6 launch of ``solver`` from its zero state against its plain
    version on the card, at the cluster size the wrapper chooses or at
    ``cluster``; returns that state (folded) and the max abs difference of
    the tiles."""
    import torch

    from schwarz_tpu_torch.ops.async_ras_2d_kernel import (
        async_ras_2d_rounds, async_ras_2d_rounds_plain)

    X, known, aux = solver.init_state()
    state = (solver._fold(X), known, aux)
    got = solver.launch(*state, cluster=cluster)
    torch.cuda.synchronize()
    C = async_ras_2d_rounds.cluster
    ref = solver.launch(*state, fn=async_ras_2d_rounds_plain)
    err = float((got[0] - ref[0]).abs().max())
    tol = 1e-5 * float(ref[0].abs().max())
    same = (torch.equal(got[1], ref[1]) and torch.equal(got[2][:, :3],
                                                        ref[2][:, :3]))
    sm.check(err <= tol and same,
             f"K6 async_ras_2d_rounds, {what}, {solver.chunk_rounds} rounds, "
             f"ranks {solver.pdy}x{solver.pdx} of {solver.ply}x{solver.plx} "
             f"windows, {C} blocks per rank"
             f"{' (chosen)' if cluster is None else ''}: max abs err "
             f"{err:.3e} <= {tol:.3e} (float64 sums of the same float32 "
             f"products: equal up to ties), known bits, rn0, done_at and "
             f"round counter equal: {same}")
    return state, err


def block_grid_phases(sm: Smoke) -> None:
    """Phases 11-13: K6 against its plain version, the 1M-row 2-D
    free-running slice and a converging 2-D solve."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    from schwarz_tpu_torch import diagnostics
    from schwarz_tpu_torch.models import (anisotropic_diffusion_2d,
                                          laplacian_2d)
    from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
    from schwarz_tpu_torch.ops.async_ras_2d_kernel import (
        async_ras_2d_rounds, async_ras_2d_rounds_plain)
    from schwarz_tpu_torch.ras import make_free_running_solver, solve

    t0 = time.perf_counter()
    A = laplacian_2d(1024)
    b = np.ones(A.n)
    settings = _slice_free_settings()
    solver, refine = make_free_running_solver(A, b, 16, settings)
    torch.cuda.synchronize()
    p = solver.plan
    sm.check(isinstance(solver, AsyncRASolver2D),
             "the dispatch picks the 2-D block-grid tier for "
             "laplacian_2d(1024), 16 subdomains")
    print(f"2-D free-running setup {time.perf_counter() - t0:.1f} s: N={p.N} "
          f"blocks {p.py}x{p.px} ranks {solver.pdy}x{solver.pdx} bx={p.bx} "
          f"by={p.by} Bx={p.Bx} By={p.By} refine={refine}", flush=True)

    # --- 11. K6 against its plain version ------------------------------------
    from schwarz_tpu_torch.ops import cuda_build
    from schwarz_tpu_torch.ops.async_ras_2d_kernel import async_ras_2d_rounds

    state, err = _k6_against_plain(sm, solver, "the 2-D slice's shapes")
    chosen = async_ras_2d_rounds.cluster
    _k6_against_plain(sm, solver, "the 2-D slice's shapes", cluster=1)
    cells = solver.D * solver.ply * p.By * solver.plx * p.Bx
    # every input read once (9 coefficient planes, b, dinv, both masks, the
    # tile) and the tile written once; the operations of the planes that
    # hold a nonzero
    planes = int(sum(bool(p.coef[:, k].any()) for k in range(9)))
    n_ops = solver.chunk_rounds * solver.ninner * (2 * planes + 13) * cells
    bound, by = _bound_ms(4 * 15 * cells, n_ops, "float32")
    ms1 = sm.ms(lambda: solver.launch(*state, cluster=1), 3)
    sm.kernels["async_ras_2d"] = dict(
        max_abs_err=err, cluster=chosen,
        ms=sm.ms(lambda: solver.launch(*state), 3),
        plain_ms=sm.ms(lambda: solver.launch(
            *state, fn=async_ras_2d_rounds_plain), 1),
        bound_ms=bound, bound_by=by, library_ms=None)
    ms1b = sm.ms(lambda: solver.launch(*state, cluster=1), 3)
    sm.kernels["async_ras_2d"]["ms_one_block"] = (ms1 + ms1b) / 2
    fits = [cuda_build.library("async_ras_2d").async_ras_2d_max_clusters(
        9 if planes == 9 else 5, c) for c in range(8, 0, -1)]
    for c in (4, 8):
        if c != chosen and fits[8 - c] >= solver.D:
            t = sm.ms(lambda: solver.launch(*state, cluster=c), 3)
            print(f"K6 at {c} blocks per rank: {t:.4f} ms per launch",
                  flush=True)
    v = sm.kernels["async_ras_2d"]
    print(f"async_ras_2d: ms={v['ms']:.4f} at {chosen} blocks per rank "
          f"({chosen * solver.D} of the card's SMs), {ms1:.4f} / {ms1b:.4f} "
          f"ms at 1 block per rank (before / after); plain_ms="
          f"{v['plain_ms']:.4f} bound_ms={v['bound_ms']:.4f} "
          f"({v['bound_by']}, {planes} nonzero planes, {cells} cells) "
          f"library_ms=None; clusters the card holds at 8..1 blocks: {fits}",
          flush=True)
    A256 = laplacian_2d(256)
    An = anisotropic_diffusion_2d(128, eps=5.0, theta=0.4)
    small = dict(tolerance=1e-3, ninner=8, chunk_rounds=16)
    for what, mat, grid, extra in (
            ("16 blocks folded onto 4 ranks", A256, (4, 4),
             dict(num_ranks=4)),
            ("staleness 2", A256, (2, 2), dict(staleness=2)),
            ("9-point anisotropic operator with O-RAS", An, (4, 2),
             dict(oras_weight=-0.8))):
        _k6_against_plain(sm, AsyncRASolver2D(
            mat, np.ones(mat.n), *grid, **small, **extra), what)

    # --- 12. the 1M-row 2-D free-running slice, cold then warm ---------------
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        res, launches = counted(lambda: solve(A, b, settings, 16))
        wall = time.perf_counter() - t0
        n_l = launches["async_ras_2d"]
        n_rounds = n_l * solver.chunk_rounds
        print(f"2-D free-running slice ({tag}): {n_rounds} rounds in {n_l} "
              f"launches of {async_ras_2d_rounds.cluster} blocks per rank, "
              f"run loop {res.solve_time_s:.4f} s = "
              f"{1e3 * res.solve_time_s / max(n_rounds, 1):.3f} ms/round, "
              f"solve() wall with setup {wall:.2f} s, converged="
              f"{res.converged}, true relative residual "
              f"{res.relative_residual_norm:.6e}", flush=True)
        if tag == "cold":
            sm.check(n_l > 0 and launches["async_ras"] == 0,
                     f"async_ras_2d launched {n_l} times on the 2-D slice, "
                     f"async_ras {launches['async_ras']} times")
            sm.kernels["async_ras_2d"]["launches"] = n_l
            sm.check(res.solution.shape == (A.n,) and bool(np.isfinite(
                res.solution).all()) and np.isfinite(
                res.relative_residual_norm),
                f"2-D free-running slice: finite solution, finite true "
                f"relative residual {res.relative_residual_norm:.6e} (64 "
                f"rounds of 16 inner iterations on 256 x 256 blocks are the "
                f"start of the transient; phase 13 converges)")
            sm.slice_refs["slice_2d"] = res.solution
    k6_ms = sm.kernels["async_ras_2d"]["ms"]
    print(f"where the time goes (warm): K6 {k6_ms:.3f} ms per "
          f"{solver.chunk_rounds}-round launch (events, phase 11) x {n_l} "
          f"launches = {k6_ms * n_l:.3f} ms of a "
          f"{1e3 * res.solve_time_s:.3f} ms run loop "
          f"({100 * k6_ms * n_l / (1e3 * res.solve_time_s):.1f}%)",
          flush=True)
    del solver

    # --- 13. a converging 2-D solve: card against CPU ------------------------
    b2 = np.ones(A256.n)
    kw = dict(px=4, py=2, tolerance=2e-3, staleness=1, ninner=30,
              chunk_rounds=20, num_ranks=8)
    x_c, i_c = AsyncRASolver2D(A256, b2, **kw).run(max_rounds=400)
    t0 = time.perf_counter()
    x_h, i_h = AsyncRASolver2D(A256, b2, device="cpu", **kw).run(
        max_rounds=400)
    t_cpu = time.perf_counter() - t0
    x_ref = spla.spsolve(A256.to_scipy().tocsc(), b2)
    e_ref = float(np.linalg.norm(x_c - x_ref) / np.linalg.norm(x_ref))
    print(f"256^2 2-D free-running, 4x2 blocks, 8 ranks: card done_at "
          f"{i_c['done_at'].tolist()} in {i_c['rounds']} rounds, "
          f"{i_c['time_s']:.4f} s, true rel "
          f"{i_c['relative_residual_norm']:.6e}, error against spsolve "
          f"{e_ref:.3e}; CPU done_at {i_h['done_at'].tolist()}, true rel "
          f"{i_h['relative_residual_norm']:.6e}, {t_cpu:.1f} s; max "
          f"|x_card - x_cpu| {np.abs(x_c - x_h).max():.3e}.  (The JAX "
          f"package, float32 sums, on an 8-device CPU mesh: done_at "
          f"[266, 266, 268, 268, 268, 266, 268, 270] in 280 rounds, true "
          f"rel 2.13e-3; equality with it is not required.)", flush=True)
    sm.check(i_c["converged"] and len(np.unique(i_c["done_at"])) > 1
             and np.array_equal(i_c["done_at"], i_h["done_at"])
             and i_c["relative_residual_norm"] < 1e-2 and e_ref < 5e-3,
             "256^2 2-D free-running converges on the card with unequal "
             "done_at equal to the CPU run's, true residual < 1e-2, error "
             "against spsolve < 5e-3")
    sm.free_refs["2d"] = (x_c, i_c)
    covered = diagnostics.flag_order_passed("cuda")
    _, i_f = AsyncRASolver2D(A256, b2, **{**kw, "staleness": 3},
                             fresh_read=True).run(max_rounds=800)
    print(f"2-D fresh_read, staleness 3, ranks of "
          f"{async_ras_2d_rounds.cluster} blocks after a probe that passed "
          f"at C = {covered}: done_at {i_f['done_at'].tolist()}, hits "
          f"{i_f['fresh_read_hits']}, true rel "
          f"{i_f['relative_residual_norm']:.6e}", flush=True)
    sm.check(i_f["converged"] and i_f["fresh_read_hits"] > 0
             and i_f["relative_residual_norm"] < 1e-2
             and async_ras_2d_rounds.cluster <= covered,
             "2-D fresh_read at staleness 3 converges with hits > 0, its "
             "cluster size covered by the probe")
    _, i_r = AsyncRASolver2D(A256, b2, **kw).run_refined(tol=1e-8,
                                                         max_rounds=400)
    print(f"2-D run_refined(tol=1e-8): {i_r['restarts']} restarts, "
          f"{i_r['rounds']} rounds, true rel "
          f"{i_r['relative_residual_norm']:.6e}", flush=True)
    sm.check(i_r["converged"] and i_r["relative_residual_norm"] <= 1e-8,
             "2-D run_refined reaches a true relative residual <= 1e-8")


def _k7_against_plain(sm: Smoke, solver, what: str, variant=None):
    """One K7 launch of ``solver`` from its zero state, then one from that
    state (which consumes the carry), against the plain version on the card,
    at the variant the wrapper chooses or a forced one; returns the zero
    state and the max abs difference of the iterates."""
    import torch

    from schwarz_tpu_torch.ops.async_ras_general_kernel import (
        async_general_rounds, async_general_rounds_plain)

    def k7(*args, **kw):
        return async_general_rounds(*args, **kw, variant=variant)

    state = solver.init_state()
    got, ref, err, same = state, state, 0.0, True
    for _ in range(2):
        got = solver.launch(*got, fn=k7)
        torch.cuda.synchronize()
        ref = solver.launch(*ref, fn=async_general_rounds_plain)
        err = max(err, float((got[0] - ref[0]).abs().max()),
                  float((got[3] - ref[3]).abs().max()))
        same = same and (torch.equal(got[1], ref[1])
                         and torch.equal(got[2][:, :3], ref[2][:, :3]))
    p = solver.plan
    v, nt = async_general_rounds.variant, async_general_rounds.threads
    sm.check(err == 0.0 and same,
             f"K7 async_general_rounds, {what}, 2 x {solver.chunk_rounds} "
             f"rounds, {p.S} ranks, Rext={p.Rext} K={p.K} C={p.C} "
             f"SEG={p.SEG}, {v} variant"
             f"{' (chosen)' if variant is None else ''}, {nt} threads a "
             f"block: max abs difference of iterate and carry {err:.3e} "
             f"== 0 (the same float32 operations in the same order, float64 "
             f"sums), known bits, rn0, done_at and round counter equal: "
             f"{same}")
    return state, err


def general_graph_phases(sm: Smoke) -> None:
    """Phases 14-16: K7 against its plain version, the 129 600-row general
    free-running slice and a converging solve on an unstructured matrix."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import Partition, Settings
    from schwarz_tpu_torch.core.partition import make_partition
    from schwarz_tpu_torch.models import (advection_diffusion_2d,
                                          anisotropic_diffusion_2d,
                                          laplacian_2d, matrix_path, read_mtx)
    from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
    from schwarz_tpu_torch.ops.async_ras_general_kernel import (
        async_general_rounds, async_general_rounds_plain)
    from schwarz_tpu_torch.ras import make_free_running_solver, solve

    S = 128
    A = anisotropic_diffusion_2d(360, eps=5.0, theta=0.3)
    b = np.ones(A.n)
    settings = _slice_free_settings(partition=Partition.metis)
    t0 = time.perf_counter()
    part = make_partition(A, S, settings)
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver, refine = make_free_running_solver(A, b, S, settings,
                                              partition_indices=part)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    p = solver.plan
    sm.check(isinstance(solver, AsyncGeneralRASolver),
             "the dispatch picks the general-graph tier for a metis "
             "partition")
    sizes = np.bincount(part, minlength=S)
    links = (p.tgt_subd != np.arange(S)[:, None]).sum(axis=1)
    print(f"general free-running setup on the host: metis partition "
          f"{t_part:.1f} s, plan and upload {t_plan:.1f} s: N={p.N} S={S} "
          f"parts of {sizes.min()}-{sizes.max()} rows, Rint={p.Rint} H={p.H} "
          f"Rext={p.Rext} K={p.K} SEG={p.SEG} C={p.C}, at most "
          f"{links.max()} partners a rank, refine={refine}", flush=True)

    # --- 14. K7 against its plain version, at the variant its size takes
    # and with its data forced into device memory -----------------------------
    state, err = _k7_against_plain(sm, solver, "the general slice's shapes")
    variant = async_general_rounds.variant
    threads = async_general_rounds.threads
    _, err_g = _k7_against_plain(sm, solver, "the general slice's shapes",
                                 variant="global")
    rows = S * p.Rext
    # cols, vals, b, dinv, mask_int and x read once, x written once; per
    # extended row a residual and ninner products of K entries with the
    # vector updates and dots of a CG iteration
    n_bytes = 4 * (2 * p.K * rows + 3 * rows + 2 * S * p.Rint)
    n_ops = solver.chunk_rounds * (solver.ninner + 1) * (2 * p.K + 13) * rows
    bound, by = _bound_ms(n_bytes, n_ops, "float32")

    def k7_ms(**force):
        return sm.ms(lambda: solver.launch(*state, fn=lambda *a, **k: (
            async_general_rounds(*a, **{**k, **force}))), 3)

    sm.kernels["async_ras_general"] = dict(
        max_abs_err=max(err, err_g), variant=variant, threads=threads,
        ms=k7_ms(), ms_global=k7_ms(variant="global"),
        plain_ms=sm.ms(lambda: solver.launch(
            *state, fn=async_general_rounds_plain), 1),
        bound_ms=bound, bound_by=by, library_ms=None)
    v = sm.kernels["async_ras_general"]
    print(f"async_ras_general: ms={v['ms']:.4f} ({variant} variant, "
          f"{threads} threads a block) ms_global={v['ms_global']:.4f} "
          f"(global variant, {async_general_rounds.threads} threads a block) "
          f"plain_ms={v['plain_ms']:.4f} bound_ms={v['bound_ms']:.4f} "
          f"({v['bound_by']}, {rows} extended rows, {n_bytes} bytes, {n_ops} "
          f"operations) library_ms=None", flush=True)
    # the rounds without their inner iterations: messages and the residual
    fixed = k7_ms(ninner=0)
    per_it = (v["ms"] - fixed) / (solver.chunk_rounds * solver.ninner)
    print(f"K7 where a launch goes ({variant} variant): {fixed:.4f} ms for "
          f"{solver.chunk_rounds} rounds of messages and residual (ninner = "
          f"0), {1e3 * per_it:.3f} us per inner CG iteration of a round",
          flush=True)
    ani3 = read_mtx(matrix_path("ani3_crop.mtx"))
    ani4 = read_mtx(matrix_path("ani4_crop.mtx"))
    lap64 = laplacian_2d(64)
    metis = Settings(partition=Partition.metis)

    def general(mat, n_parts, **kw):
        return AsyncGeneralRASolver(
            mat, np.ones(mat.n), n_parts, overlap=2,
            part=make_partition(mat, n_parts, metis), **kw)

    small = dict(tolerance=1e-3, chunk_rounds=16)
    for what, mat, n_parts, extra in (
            ("ani4_crop at staleness 2", ani4, 8,
             dict(ninner=24, staleness=2)),
            ("64^2 Laplacian with O-RAS", lap64, 16,
             dict(ninner=8, oras_weight=-0.8)),
            ("64^2 advection with BiCGStab", advection_diffusion_2d(64), 8,
             dict(ninner=8, nonsym=True))):
        _k7_against_plain(sm, general(mat, n_parts, **small, **extra), what)

    # --- 15. the general free-running slice, cold then warm ------------------
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        res, launches = counted(lambda: solve(A, b, settings, S))
        wall = time.perf_counter() - t0
        n_l = launches["async_ras_general"]
        n_rounds = n_l * solver.chunk_rounds
        print(f"general free-running slice ({tag}): {n_rounds} rounds in "
              f"{n_l} launches of the {async_general_rounds.variant} variant "
              f"at {async_general_rounds.threads} threads a block, run loop "
              f"{res.solve_time_s:.4f} s = "
              f"{1e3 * res.solve_time_s / max(n_rounds, 1):.3f} ms/round, "
              f"solve() wall with partition and plan {wall:.2f} s, converged="
              f"{res.converged}, true relative residual "
              f"{res.relative_residual_norm:.6e}", flush=True)
        if tag == "cold":
            sm.check(n_l > 0 and launches["async_ras"] == 0
                     and launches["async_ras_2d"] == 0,
                     f"async_ras_general launched {n_l} times on the general "
                     f"slice, async_ras {launches['async_ras']} times, "
                     f"async_ras_2d {launches['async_ras_2d']} times")
            sm.kernels["async_ras_general"]["launches"] = n_l
            sm.check(res.solution.shape == (A.n,) and bool(np.isfinite(
                res.solution).all()) and np.isfinite(
                res.relative_residual_norm),
                f"general free-running slice: finite solution, finite true "
                f"relative residual {res.relative_residual_norm:.6e} (64 "
                f"rounds of 16 inner iterations from a zero start are the "
                f"start of the transient; phase 16 converges)")
            sm.slice_refs["slice_general"] = res.solution
    k7_ms = sm.kernels["async_ras_general"]["ms"]
    print(f"where the time goes (warm): K7 {k7_ms:.3f} ms per "
          f"{solver.chunk_rounds}-round launch (events, phase 14) x {n_l} "
          f"launches = {k7_ms * n_l:.3f} ms of a "
          f"{1e3 * res.solve_time_s:.3f} ms run loop "
          f"({100 * k7_ms * n_l / (1e3 * res.solve_time_s):.1f}%); the host "
          f"partitions for {t_part:.1f} s and plans for {t_plan:.1f} s before "
          f"it", flush=True)
    del solver

    # --- 16. a converging general solve: card against CPU --------------------
    kw = dict(tolerance=1e-3, staleness=1, ninner=24, chunk_rounds=8)
    x_c, i_c = general(ani3, 4, **kw).run(max_rounds=400)
    x_h, i_h = general(ani3, 4, device="cpu", **kw).run(max_rounds=400)
    print(f"ani3_crop, metis, 4 ranks: card done_at {i_c['done_at'].tolist()} "
          f"in {i_c['rounds']} rounds, {i_c['time_s']:.4f} s, true rel "
          f"{i_c['relative_residual_norm']:.6e}; CPU done_at "
          f"{i_h['done_at'].tolist()}, true rel "
          f"{i_h['relative_residual_norm']:.6e}; max |x_card - x_cpu| "
          f"{np.abs(x_c - x_h).max():.3e}.  (The JAX package, dense float32 "
          f"products, on an 8-device CPU mesh with the partition its host "
          f"gives: done_at [60, 60, 58, 60] in 64 rounds, true rel 8.42e-4; "
          f"equality with it is not required.)", flush=True)
    sm.check(i_c["converged"]
             and np.array_equal(i_c["done_at"], i_h["done_at"])
             and np.array_equal(x_c, x_h)
             and i_c["relative_residual_norm"] < 5e-3,
             "ani3_crop general free-running converges on the card with "
             "done_at and solution equal to the CPU run's, true residual "
             "< 5e-3")
    sm.free_refs["general"] = (x_c, i_c)
    _, i_r = general(lap64, 8, tolerance=1e-4, ninner=16,
                     chunk_rounds=16).run_refined(tol=1e-8, max_rounds=800)
    print(f"general run_refined(tol=1e-8), 64^2 Laplacian, metis, 8 ranks: "
          f"{i_r['restarts']} restarts, {i_r['rounds']} rounds, true rel "
          f"{i_r['relative_residual_norm']:.6e}", flush=True)
    sm.check(i_r["converged"] and i_r["relative_residual_norm"] <= 1e-8,
             "general run_refined reaches a true relative residual <= 1e-8")
    x4, i4 = general(ani4, 8, **kw).run(max_rounds=400)
    print(f"ani4_crop, metis, 8 ranks, in band: done_at "
          f"{i4['done_at'].tolist()} in {i4['rounds']} rounds, true rel "
          f"{i4['relative_residual_norm']:.6e}", flush=True)
    sm.check(bool(np.isfinite(x4).all())
             and np.isfinite(i4["relative_residual_norm"]),
             "ani4_crop general free-running stays finite in band (its "
             "refined solve needs the coarse space)")


def exchange_kernel_checks(sm: Smoke, dec) -> None:
    """Phase 17: K4 against its plain version, as one shift and as one whole
    exchange of the rdma slice (``dec`` on 16 ranks), and timed; K2 over
    the halo values that exchange delivers, against its plain version."""
    import torch

    from schwarz_tpu_torch.ops.rdma_kernel import (exchange_rounds_plain,
                                                   rdma_cyclic_shift,
                                                   rdma_cyclic_shift_plain,
                                                   rdma_exchange,
                                                   rdma_exchange_launch,
                                                   rdma_exchange_plain,
                                                   rdma_shift_launch)
    from schwarz_tpu_torch.ops.halo_kernel import (assemble_x_ext,
                                                   assemble_x_ext_plain)
    from schwarz_tpu_torch.parallel.exchange import segments_of
    from schwarz_tpu_torch.parallel.neighbor_exchange import (
        build_neighbor_plan, exchange_rounds)

    variants = (("put", False, False), ("get", False, False),
                ("put", True, False), ("put", True, True),
                ("get", True, True))
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = 0.0
    for D, H, offset, dt in ((16, 3072, 1, torch.float32),
                             (16, 3072, 15, torch.float64),
                             (2, 5, 1, torch.float64),
                             (64, 37, 9, torch.float32)):
        buf = torch.randn((D, H), generator=gen, device="cuda", dtype=dt)
        for mode, one_by_one, flush_local in variants:
            out, counts = rdma_cyclic_shift(buf, offset, mode, one_by_one,
                                            flush_local)
            torch.cuda.synchronize()
            ref, ref_counts = rdma_cyclic_shift_plain(
                buf, offset, mode, one_by_one, flush_local)
            err = float((out - ref).abs().max())
            worst = max(worst, err)
            sm.check(bool(torch.equal(out, ref))
                     and bool(torch.equal(counts, ref_counts)),
                     f"K4 rdma_cyclic_shift D={D} H={H} offset={offset} "
                     f"{str(dt).split('.')[-1]} {mode}"
                     f"{' one-by-one' if one_by_one else ''}"
                     f"{' flush-local' if flush_local else ''}: data bit for "
                     f"bit (max abs err {err}), signals received "
                     f"{counts[0, 0].item()}, requests served "
                     f"{counts[0, 1].item()}, equal to the plain version's")
    # the fused exchange of the rdma slice: 2 rounds of 16 x 3072 float32,
    # pack and unpack in the launch, on the slice's own tables
    D = 16
    nx = build_neighbor_plan(dec, D)
    rounds = exchange_rounds(nx, "cuda")
    x = torch.randn((dec.meta.num_subdomains, dec.meta.max_interior),
                    generator=gen, device="cuda")
    widths = [t.shape[1] for t in nx.send_idx]
    # K2 in the form the neighbour strategies launch it: the window from
    # x_own, the halo from K4's compact (S, H) values
    segs, first = (torch.from_numpy(t).cuda() for t in segments_of(dec, True))
    R_ext = dec.meta.max_ext
    for halo_dtype in (None, torch.bfloat16):
        for mode, one_by_one, flush_local in variants:
            halo, counts = rdma_exchange(x, rounds, halo_dtype, mode,
                                         one_by_one, flush_local)
            torch.cuda.synchronize()
            ref, ref_counts = rdma_exchange_plain(x, rounds, halo_dtype, mode,
                                                  one_by_one, flush_local)
            err = float((halo - ref).abs().max())
            worst = max(worst, err)
            sm.check(bool(torch.equal(halo, ref))
                     and bool(torch.equal(counts, ref_counts)),
                     f"K4 rdma_exchange, the rdma slice's {len(widths)} "
                     f"rounds of {widths} elements in one launch, halo "
                     f"{str(halo_dtype or x.dtype).split('.')[-1]}, {mode}"
                     f"{' one-by-one' if one_by_one else ''}"
                     f"{' flush-local' if flush_local else ''}: halo values "
                     f"bit for bit (max abs err {err}), per-round counts "
                     f"{counts[:, 0].tolist()} equal to the plain version's")
        halo, _ = rdma_exchange(x, rounds, halo_dtype)
        got = assemble_x_ext(x, halo, segs, first, R_ext)
        torch.cuda.synchronize()
        ref = assemble_x_ext_plain(x, halo, segs, first, R_ext)
        sm.check(bool(torch.equal(got, ref)),
                 f"K2 assemble_x_ext over K4's halo values (halo "
                 f"{str(halo_dtype or x.dtype).split('.')[-1]}), "
                 f"{segs.shape[0]} segments: bit-identical to the plain "
                 f"version (max abs err {float((got - ref).abs().max())})")
    bound_b, _ = _k2_bound(segs, first, x.shape[0], R_ext, False)
    t_b = sm.ms(lambda: assemble_x_ext(x, halo, segs, first, R_ext), 50)
    print(f"K2 over K4's halo values ({segs.shape[0]} segments, halo "
          f"{tuple(halo.shape)}): {t_b:.5f} ms, bound {bound_b:.6f} ms",
          flush=True)
    # bytes the fused launch must move: the packed values read from x_own
    # with their send indices, each window element written and read, the
    # unpack table read, the own-block values read and halo_vals written
    n_pack = D * sum(widths)
    n_slots = rounds.is_local.numel()
    n_local = int(rounds.is_local.sum())
    bound, by = _bound_ms(n_pack * (4 + 4 + 2 * 4) + n_slots * (4 + 4)
                          + n_local * 4, 0, "float32")

    def one_round_path():
        # the first version: the torch pack, one K4 launch per round, the
        # torch unpack
        return exchange_rounds_plain(
            x, rounds, None, lambda b, r: rdma_shift_launch(b, r)[0])

    def rolls():
        return [torch.roll(b, r, 0) for b, r in zip(bufs, nx.offsets)]

    bufs = [torch.randn((D, w), generator=gen, device="cuda") for w in widths]
    roll = lambda b, r: torch.roll(b, r, 0)  # noqa: E731
    t_old = sm.ms(one_round_path, 50)
    sm.kernels["rdma_shift"] = dict(
        max_abs_err=worst, rounds_per_launch=len(widths),
        ms=sm.ms(lambda: rdma_exchange_launch(x, rounds), 50),
        plain_ms=sm.ms(lambda: rdma_exchange_plain(x, rounds), 50),
        bound_ms=bound, bound_by=by, library_ms=sm.ms(rolls, 50))
    t_pp = sm.ms(lambda: exchange_rounds_plain(x, rounds, None, roll), 50)
    t_old2 = sm.ms(one_round_path, 50)
    v = sm.kernels["rdma_shift"]
    print(f"rdma_exchange (put, {len(widths)} rounds of D={D} x {widths} "
          f"float32 with pack and unpack, one launch): ms={v['ms']:.4f} "
          f"plain_ms={v['plain_ms']:.4f} bound_ms={v['bound_ms']:.6f} "
          f"({v['bound_by']}) library_ms={v['library_ms']:.4f} "
          f"({len(widths)} x torch.roll); the ppermute transport's whole "
          f"exchange {t_pp:.4f}; the first version's path (torch pack, "
          f"{len(widths)} one-round launches, torch unpack) {t_old:.4f} / "
          f"{t_old2:.4f} (before / after)", flush=True)
    for mode, one_by_one, flush_local in variants[1:]:
        t = sm.ms(lambda: rdma_exchange_launch(x, rounds, None, mode,
                                               one_by_one, flush_local), 20)
        print(f"  variant {mode}{' one-by-one' if one_by_one else ''}"
              f"{' flush-local' if flush_local else ''}: {t:.4f} ms",
              flush=True)
    t = sm.ms(lambda: rdma_exchange(x, rounds), 20)
    print(f"  with the wrapper's wait for the error word (one host sync): "
          f"{t:.4f} ms", flush=True)
    # what a launch and a handoff cost with nothing to move: one round of
    # one element a rank, beside a one-element PyTorch op (the timing's own
    # floor: one launch between two events)
    one = torch.zeros((D, 1), device="cuda")
    t_handoff = sm.ms(lambda: rdma_shift_launch(one, 1), 50)
    t_launch = sm.ms(lambda: one.add_(1), 50)
    print(f"  floors: one K4 launch with one handoff and one element a rank "
          f"{t_handoff:.4f} ms; one one-element torch op {t_launch:.4f} ms",
          flush=True)


def neighbor_exchange_phases(sm: Smoke, dec, solver, hist4,
                             ms_per_it4: float) -> None:
    """Phases 17-19: K4 against its plain version, the synchronous slice
    through the one-sided strategy (``solver``, on 16 ranks), and
    converging solves on a 2-D partition with the stale-halo modes and the
    convergence protocols."""
    import numpy as np

    from schwarz_tpu_torch import (CommSettings, ConvergenceSettings,
                                   GlobalConvergence, HaloStrategy,
                                   Partition, Settings)
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
    from schwarz_tpu_torch.ras import solve

    # --- 17. K4 against its plain version ------------------------------------
    exchange_kernel_checks(sm, dec)

    # --- 18. the synchronous slice through the one-sided strategy ------------
    nx = solver._neighbor_plan
    for tag in ("cold", "warm"):
        res, launches = counted(solver.run)
        n_it = len(res.global_resnorm_history)
        ms_it = 1e3 * res.solve_time_s / max(n_it, 1)
        print(f"rdma slice ({tag}): {n_it} outer iterations, offsets "
              f"{nx.offsets}, buffers of {[t.shape[1] for t in nx.send_idx]} "
              f"elements, wall {res.solve_time_s:.3f} s = {ms_it:.2f} "
              f"ms/iteration (all_gather, phase 4: {ms_per_it4:.2f}), "
              f"launches {launches}", flush=True)
        if tag == "cold":
            sm.check(launches["rdma_shift"] == n_it > 0,
                     f"rdma_shift launched {launches['rdma_shift']} times: "
                     f"one launch for the {len(nx.offsets)} rounds of each "
                     f"of the {n_it} exchanges")
            sm.check(launches["dia_spmv"] > 0 and launches["fused_cg"] > 0
                     and launches["halo_runs"] == n_it,
                     f"the rdma slice launched K1 and K3, and K2 once per "
                     f"exchange ({launches['halo_runs']})")
            sm.kernels["rdma_shift"]["launches"] = launches["rdma_shift"]
            sm.check(np.array_equal(res.global_resnorm_history, hist4),
                     "rdma slice: global residual history equal to the "
                     "all_gather slice's bit for bit")
    k4_ms = sm.kernels["rdma_shift"]["ms"]
    print(f"where the time goes (warm): K4 {k4_ms:.4f} ms per exchange "
          f"(events, phase 17) x {launches['rdma_shift']} launches = "
          f"{k4_ms * launches['rdma_shift']:.3f} ms of a "
          f"{1e3 * res.solve_time_s:.3f} ms run loop", flush=True)
    del solver

    # --- 19. a 2-D partition, stale halos and the protocols: card and CPU ----
    A = laplacian_2d(32)
    b = generate_rhs(A.n, random=False)

    def both(what, comm=None, rtol=1e-8, **kw):
        s = Settings(partition=Partition.regular2d, overlap=2,
                     max_iters=1500, comm=CommSettings(**(comm or {})),
                     **{"tolerance": 1e-6, **kw})
        t0 = time.perf_counter()
        r_c, launches = counted(lambda: solve(A, b, s, 64, num_ranks=16))
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_h = solve(A, b, s, 64, device="cpu", num_ranks=16)
        t_h = time.perf_counter() - t0
        same = r_c.iters == r_h.iters
        rel = (np.abs(r_c.global_resnorm_history
                      / r_h.global_resnorm_history - 1).max()
               if same else float("inf"))
        print(f"{what}: card {r_c.iters} iterations in {t_c:.1f} s, CPU "
              f"{r_h.iters} in {t_h:.1f} s, histories max rel diff "
              f"{rel:.3e}, true relative residual "
              f"{r_c.relative_residual_norm:.3e}, K4 launches "
              f"{launches['rdma_shift']}", flush=True)
        sm.check(r_c.converged and same and rel <= rtol,
                 f"{what}: converges on the card in the CPU run's "
                 f"{r_h.iters} iterations, histories within rtol {rtol:g}")
        return r_c, launches

    rdma_get = dict(strategy=HaloStrategy.rdma)
    r_ag, _ = both("64 subdomains on 16 ranks, all_gather")
    r_rd, launches = both("the same, rdma in get mode", comm=rdma_get)
    sm.rdma_get_iters = r_rd.iters          # phase 32 runs it on 2 processes
    sm.check(r_rd.iters == r_ag.iters and launches["rdma_shift"] > 0
             and r_rd.relative_residual_norm < 1e-5
             and np.array_equal(r_rd.solution, r_ag.solution),
             f"rdma in get mode: the all_gather run's {r_ag.iters} "
             f"iterations and solution, true relative residual "
             f"{r_rd.relative_residual_norm:.3e} < 1e-5")
    for what, comm, kw in (
            ("overlap_comm", dict(overlap_comm=True, **rdma_get), {}),
            ("onesided staleness 3",
             dict(onesided=True, staleness=3, **rdma_get), {}),
            ("tree detection", rdma_get, dict(
                convergence=ConvergenceSettings(
                    method=GlobalConvergence.tree))),
            ("decentralized detection (gossip)", rdma_get, dict(
                convergence=ConvergenceSettings(
                    method=GlobalConvergence.decentralized))),
            ("decentralized detection (accumulate)", rdma_get, dict(
                convergence=ConvergenceSettings(
                    method=GlobalConvergence.decentralized,
                    enable_accumulate=True)))):
        r, _ = both(what, comm=comm, **kw)
        sm.check(r.iters >= r_ag.iters,
                 f"{what}: {r.iters} iterations >= the plain run's "
                 f"{r_ag.iters}")
    # float32 halos stall the local detection ratio near 1e-6: tolerance 1e-4
    both("halo_dtype float32 under float64", comm=rdma_get,
         halo_dtype="float32", tolerance=1e-4)
    # a 2-byte halo stalls the ratio near 0.15 (the CPU run's history); at
    # 0.25 the CPU run stops after 35 iterations.  Card and CPU round the
    # same halo values to bfloat16, but values that differ in their last
    # float64 bits can round one bfloat16 step (2^-8) apart: rtol 1e-2
    both("halo_dtype bfloat16 under float64", comm=rdma_get, rtol=1e-2,
         halo_dtype="bfloat16", tolerance=0.25)


# the flagship recipe, bench.py:531-539
FLAGSHIP = dict(overlap=6, tolerance=1e-8, max_iters=200, dtype="float64",
                local_compute_dtype="float32", local_tolerance=1e-6,
                local_max_iters=20, row_pad_multiple=128, two_level=True,
                coarse_aggregates=32, coarse_space="spectral")


# the flagship's card history against its CPU history, both DIA: float32
# local CG sums in another order.  After the first outer iteration the gap
# read 6.3e-7 on an H100; the port against the JAX package on the CPU reads
# 7.5e-7 there on the 64^2 analog, and 1.2e-5 with FSAI's factors rounded
# to bfloat16.  Over the whole history it grows as each iteration adds its
# own rounding: 7.2e-4 on the H100 (4.7e-5 over the analog's 10).
FLAGSHIP_FIRST_RTOL = 4e-6
FLAGSHIP_HISTORY_RTOL = 2e-3


def flagship_phases(sm: Smoke) -> None:
    """Phases 20-23: the flagship recipe at full size on the card and on
    the CPU, K1 at its shapes, a converging O-RAS run through K3 on the
    Robin-modified operator, and two-level free-running refinement."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from schwarz_tpu_torch import (Partition, Precond, RASolver, Settings,
                                   solve)
    from schwarz_tpu_torch.coarse_correction import spectral_coarse_basis
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
    from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
    from schwarz_tpu_torch.ops.dia_kernel import dia_spmv
    from schwarz_tpu_torch.ops.fused_cg import (fused_cg_solve,
                                                fused_cg_solve_plain)

    # the eigenvectors go to a cache inside the checkout, cleared first, so
    # the card's setup solves them and the CPU's setup reads them
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "coarse_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["SCHWARZ_TPU_COARSE_CACHE"] = cache

    # --- 20. the flagship at full size: card, then CPU -----------------------
    A = laplacian_2d(512)
    b = generate_rhs(A.n)
    s = Settings(partition=Partition.regular, precond=Precond.fsai,
                 **FLAGSHIP)
    S = 16
    t0 = time.perf_counter()
    dec = decompose(A, b, s, S)
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    spectral_coarse_basis(dec, s.coarse_aggregates, dec.meta.max_interior)
    t_eig = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = RASolver(dec)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    m = solver.meta
    print(f"flagship setup on the host: partition + decompose {t_dec:.2f} "
          f"s, 16 Neumann eigensolves (q = {s.coarse_aggregates}) and the "
          f"Galerkin product {t_eig:.2f} s, plan (FSAI build, coarse "
          f"inverse, copies to the card) {t_plan:.2f} s, total "
          f"{t_dec + t_eig + t_plan:.2f} s; N={m.global_size} S={S} "
          f"R_int={m.max_interior} R_rows={m.max_rows} R_ext={m.max_ext} "
          f"offsets={solver._dia_offsets} fsai={solver._fsai_offsets} "
          f"remainder={solver._dia_has_remainder}", flush=True)
    res, launches = counted(solver.run)
    by_operand = dict(dia_spmv.launches_by)    # before any other K1 launch
    sm.flagship_iters = res.iters
    sm.flagship_hist = res.global_resnorm_history
    warm = solver.run()
    n_run = len(warm.global_resnorm_history)
    ms_it = 1e3 * warm.solve_time_s / max(n_run, 1)
    sm.flagship_ms_it = ms_it
    print(f"flagship on the card: {res.iters} iterations, converged="
          f"{res.converged}, true relative residual (float64, host) "
          f"{res.relative_residual_norm:.6e}; run loop {res.solve_time_s:.3f}"
          f" s cold, {warm.solve_time_s:.3f} s warm ({ms_it:.2f} ms per "
          f"outer iteration over {n_run} passes); inner iterations per "
          f"outer iteration {res.inner_iters_history.max(axis=1).tolist()}",
          flush=True)
    print(f"launches in the flagship run: {launches}", flush=True)
    hist = res.global_resnorm_history
    print("flagship card history: " + " ".join(f"{v:.9e}" for v in hist),
          flush=True)
    go, uo = solver._fsai_offsets
    a_off = tuple(solver._dia_offsets)
    operands = {"A_f64": (a_off, "float64"), "A_f32": (a_off, "float32"),
                "chain": ("chain", tuple(go), tuple(uo), "float32")}
    k1 = {key: by_operand.get(op, 0) for key, op in operands.items()}
    # per outer iteration: the residual and the check (A_f64, and once on
    # the exit pass); the inner CG's A_f32 and FSAI apply once per step,
    # n + 1 for n inner iterations (the largest subdomain's count)
    n_steps = int((res.inner_iters_history[:res.iters].max(axis=1)
                   + 1).sum())
    want_k1 = {"A_f64": 2 * res.iters + 1, "A_f32": n_steps,
               "chain": n_steps}
    print(f"flagship K1 launches per outer iteration: "
          + ", ".join(f"{k} {v / max(res.iters, 1):.2f}"
                      for k, v in k1.items())
          + f"; all {launches['dia_spmv'] / max(res.iters, 1):.2f} (the "
          f"first version: 65.06, G and G^T two launches)", flush=True)
    sm.check(res.converged and res.relative_residual_norm <= 1e-8
             and res.solution.shape == (A.n,)
             and bool(np.isfinite(res.solution).all()),
             f"flagship converges on the card: {res.iters} iterations, "
             f"true relative residual {res.relative_residual_norm:.3e} "
             f"<= 1e-8 (the JAX package on a TPU: 18, 6.21e-9, "
             f"BENCH_r05.json)")
    sm.check(set(by_operand) == set(operands.values())
             and k1 == want_k1
             and launches["dia_spmv"] == sum(k1.values())
             and launches["halo_runs"] == 2 * res.iters + 1
             and launches["fused_cg"] == 0,
             f"flagship: K1 launched {launches['dia_spmv']} times, by "
             f"operand {k1} as its wrapper counted them = {want_k1} from "
             f"the {res.iters} outer and {n_steps} inner steps (FSAI's G^T "
             f"(G r) one chained launch; launches by offsets and type "
             f"{by_operand}), K2 "
             f"{launches['halo_runs']} = 2 per outer iteration + the exit "
             f"pass, K3 not at all (FSAI locals)")
    # the profiler's view of one warm run: launches by kernel, device busy.
    # The profiler keeps only the device records that lie inside its
    # window as placed on the host's clock, so the run is kept clear of the
    # window's edges: the card idle and 20 ms on each side
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.02)
        t0 = time.perf_counter()
        _, lp = counted(solver.run)
        wall = time.perf_counter() - t0
        time.sleep(0.02)
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    dev_us = sum(e.self_device_time_total for e in events)
    # K1's two kernels: one product, and the chain
    n_k1 = sum(e.count for e in events if "dia_spmv_" in e.key)
    n_chain = sum(e.count for e in events
                  if "dia_spmv_chain_kernel" in e.key)
    n_k2 = sum(e.count for e in events if "assemble_kernel" in e.key)
    print(f"flagship profile, one warm run of {n_run} passes: wall "
          f"{wall * 1e3:.2f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / 1e3 / (wall * 1e3):.1f}%); K1 {n_k1} launches "
          f"({n_k1 / max(res.iters, 1):.2f} per outer iteration, {n_chain} "
          f"of them the chain), K2 {n_k2} "
          f"({n_k2 / max(res.iters, 1):.2f} per outer iteration)",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:70]}", flush=True)
    groups = {"K1": "dia_spmv_", "K2": "assemble_kernel",
              "reductions": "reduce_kernel", "products (cuBLAS)": "gemm",
              "copies": "Memcpy"}
    share = {g: sum(e.self_device_time_total for e in events
                    if k in e.key) / 1e3 for g, k in groups.items()}
    print(f"flagship device ms by kind: {share}, the rest "
          f"{dev_us / 1e3 - sum(share.values()):.3f}", flush=True)
    chain_p = dia_spmv.launches_by.get(operands["chain"], 0)
    sm.check(n_k1 == lp["dia_spmv"] and n_k2 == lp["halo_runs"]
             and n_chain == chain_p > 0,
             f"flagship profile: K1 {n_k1} launches ({n_chain} chained) and "
             f"K2 {n_k2}, as counted by their wrappers ({lp['dia_spmv']}, "
             f"{chain_p}, {lp['halo_runs']})")
    # the second rhs of bench.py:550-556 on the same solver, against a
    # fresh card solver on that rhs (its basis read from the cache): the
    # same plan on the same card, so bit for bit is what to expect
    b7 = generate_rhs(A.n, seed=7)
    t0 = time.perf_counter()
    solver.set_rhs(b7)
    t_set = time.perf_counter() - t0
    (r7, l7) = counted(solver.run)
    t0 = time.perf_counter()
    fresh = RASolver(decompose(A, b7, s, S))
    torch.cuda.synchronize()
    t_fresh = time.perf_counter() - t0
    f7 = fresh.run()
    del fresh
    h7, hf = r7.global_resnorm_history, f7.global_resnorm_history
    gap7 = (float(np.abs(h7 / hf - 1).max()) if len(h7) == len(hf)
            else float("inf"))
    print(f"flagship set_rhs(generate_rhs(n, seed=7)): set_rhs {t_set:.3f} "
          f"s, run loop {r7.solve_time_s:.3f} s, {r7.iters} iterations, true "
          f"relative residual {r7.relative_residual_norm:.6e}; a fresh "
          f"solver's setup {t_fresh:.2f} s (basis from the cache), "
          f"{f7.iters} iterations; beside the first solve's setup "
          f"{t_dec + t_eig + t_plan:.2f} s and warm run loop "
          f"{warm.solve_time_s:.3f} s; launches {l7}", flush=True)
    sm.check(r7.converged and r7.relative_residual_norm <= 1e-8
             and f7.converged and r7.iters == f7.iters and gap7 <= 1e-10
             and l7["dia_spmv"] > 0 and l7["halo_runs"] == 2 * r7.iters + 1,
             f"flagship set_rhs converges in the fresh solver's "
             f"{f7.iters} iterations ({r7.iters}), histories within "
             f"{gap7:.3e} <= 1e-10, through K1 and K2")
    solver.set_rhs(b)
    # the CPU takes the card's DIA layout (its 'auto' picks ELL), so both
    # sides run the same local operator and the same FSAI factors
    t0 = time.perf_counter()
    cpu_solver = RASolver(decompose(A, b, dataclasses.replace(
        s, spmv_format="dia"), S), device="cpu")
    t_cpu_setup = time.perf_counter() - t0
    same_layout = (cpu_solver._dia_offsets == solver._dia_offsets
                   and cpu_solver._fsai_offsets == solver._fsai_offsets)
    cpu = cpu_solver.run()
    h_cpu = cpu.global_resnorm_history
    print(f"flagship on the CPU (setup {t_cpu_setup:.2f} s, basis from the "
          f"cache; DIA offsets {cpu_solver._dia_offsets}, FSAI "
          f"{cpu_solver._fsai_offsets}): {cpu.iters} iterations, true "
          f"relative residual "
          f"{cpu.relative_residual_norm:.6e}, run loop "
          f"{cpu.solve_time_s:.2f} s", flush=True)
    print("flagship CPU history: " + " ".join(f"{v:.9e}" for v in h_cpu),
          flush=True)
    n = min(len(hist), len(h_cpu))
    gaps = np.abs(hist[:n] / h_cpu[:n] - 1)
    rel, first = float(gaps.max()), float(gaps[1])
    sm.check(same_layout and cpu.converged
             and abs(cpu.iters - res.iters) <= 1
             and cpu.relative_residual_norm <= 1e-8
             and first <= FLAGSHIP_FIRST_RTOL
             and rel <= FLAGSHIP_HISTORY_RTOL,
             f"flagship card vs CPU, both DIA: {res.iters} / {cpu.iters} "
             f"iterations (a difference of one only with both histories, "
             f"printed above), histories within {first:.3e} <= "
             f"{FLAGSHIP_FIRST_RTOL:g} after the first outer iteration and "
             f"{rel:.3e} <= {FLAGSHIP_HISTORY_RTOL:g} over the common "
             f"entries")
    del cpu_solver

    # --- 21. K1 at the flagship's shapes against its plain version -----------
    plan = solver._plan
    gen = torch.Generator(device="cuda").manual_seed(1)
    x64 = torch.randn((S, m.max_ext), generator=gen, device="cuda",
                      dtype=torch.float64)
    x32 = torch.randn((S, m.max_rows), generator=gen, device="cuda")
    for key, offs, dia, x in (
            ("A_f64", solver._dia_offsets, plan["dia_vals"], x64[:, :m.max_rows]),
            ("A_f32", solver._dia_offsets, plan["dia_vals_lc"], x32),
            ("G", go, plan["fsai_gl_dia"], x32),
            ("GT", uo, plan["fsai_gu_dia"], x32)):
        e = k1_entry(sm, offs, dia, x,
                     f"at the flagship's {key} {tuple(dia.shape)} offsets "
                     f"{offs}")
        # G and G^T run inside the chain on the path: their single
        # launches are timed, not counted, and stay out of the kernels line
        e["launches"] = k1.get(key, 0)
        if key in k1:
            sm.kernels[f"dia_spmv_flagship_{key}"] = e
        print(f"K1 flagship {key}: ms={e['ms']:.5f} plain_ms="
              f"{e['plain_ms']:.5f} bound_ms={e['bound_ms']:.5f} "
              f"({e['bound_by']}) library_ms={e['library_ms']:.5f}; "
              f"{e['launches']} launches in the run, "
              f"{e['launches'] / max(res.iters, 1):.2f} per outer iteration",
              flush=True)
    gd, ud = plan["fsai_gl_dia"], plan["fsai_gu_dia"]
    e = chain_entry(sm, go, gd, uo, ud, x32,
                    f"at the flagship's G^T (G r), {tuple(gd.shape)}")
    e["launches"] = k1["chain"]
    sm.kernels["dia_spmv_flagship_chain"] = e
    print(f"K1 flagship chain G^T (G r), tile {e['tile']}: ms={e['ms']:.5f} "
          f"two K1 launches {e['two_launches_ms']:.5f} plain_ms="
          f"{e['plain_ms']:.5f} bound_ms={e['bound_ms']:.5f} "
          f"({e['bound_by']}) library_ms={e['library_ms']:.5f} (the CSR of "
          f"G^T G) two torch.sparse.mm {e['library_two_ms']:.5f}; "
          f"{e['launches']} launches in the run, "
          f"{e['launches'] / max(res.iters, 1):.2f} per outer iteration",
          flush=True)
    # the harness's read flush against a write flush, which leaves L2 full
    # of dirty lines
    from schwarz_tpu_torch import diagnostics as dg
    from schwarz_tpu_torch.ops import cuda_build, dia_kernel

    x8 = torch.randn((256, 256), generator=gen, device="cuda")
    for what, fn in (
            ("K1 A_f32", lambda: dia_spmv(a_off, plan["dia_vals_lc"], x32)),
            ("K1 G", lambda: dia_spmv(go, gd, x32)),
            ("K1 chain", lambda: dia_kernel.dia_spmv_chain(go, gd, uo, ud,
                                                           x32)),
            ("K8 (256, 256)", lambda: dg.smoke_x2(x8))):
        t = [sm.ms(fn, 50, fl) for fl in ("read", "write", "read", "write")]
        print(f"L2 flush: {what} {t[0]:.5f} / {t[2]:.5f} ms after a read "
              f"flush, {t[1]:.5f} / {t[3]:.5f} after a write flush",
              flush=True)
    # the wrapper's host time, with its per-operand cache and with the
    # cache cleared before every call (what every call rebuilt before it)
    a32 = plan["dia_vals_lc"]

    def cold(fn):
        def call():
            dia_kernel._operands.clear()
            return fn()
        return call

    single = lambda: dia_spmv(a_off, a32, x32)             # noqa: E731
    chained = lambda: dia_kernel.dia_spmv_chain(           # noqa: E731
        go, gd, uo, ud, x32)
    us = {"dia_spmv": (host_us(single), host_us(cold(single))),
          "dia_spmv_chain": (host_us(chained), host_us(cold(chained)))}
    print("host us a call over 1000 calls, no synchronize, at the "
          "flagship's shapes: " + ", ".join(
              f"{k} {a:.2f} with the per-operand cache, {b:.2f} with it "
              f"cleared before each call" for k, (a, b) in us.items())
          + "; the stream's handle {:.2f} through PyTorch's raw getter "
          "(cuda_build.stream_ptr), {:.2f} through "
          "torch.cuda.current_stream".format(
              host_us(lambda: cuda_build.stream_ptr(x32.device)),
              host_us(lambda: torch.cuda.current_stream(
                  x32.device).cuda_stream)), flush=True)
    del solver, plan

    # --- 22. a converging synchronous O-RAS run through K3 -------------------
    A3 = laplacian_2d(128)
    b3 = generate_rhs(A3.n, random=False)
    s3 = Settings(overlap=6, tolerance=1e-8, max_iters=400, dtype="float64",
                  local_compute_dtype="float32", local_tolerance=1e-6,
                  local_max_iters=50, fused_local_cg=True,
                  precond=Precond.jacobi, row_pad_multiple=128,
                  spmv_format="dia", oras_weight="auto")
    oras = RASolver(decompose(A3, b3, s3, 16))
    p3 = oras._plan
    K3_args = (oras._dia_offsets, p3["dia_vals_solve_lc"],
               p3["local_rhs"].float(), torch.zeros_like(p3["local_rhs"],
                                                         dtype=torch.float32),
               p3["precond_dinv"], s3.local_tolerance, s3.local_max_iters)
    ref = fused_cg_solve_plain(*K3_args)
    got = fused_cg_solve(*K3_args)
    torch.cuda.synchronize()
    err = float((got.x - ref.x).abs().max())
    tol = 1e-3 * float(ref.x.abs().max())
    d_it = int((got.iters - ref.iters).abs().max())
    C, var = fused_cg_solve.cluster, fused_cg_solve.variant
    sm.check(err <= tol and d_it <= 1,
             f"K3 on the O-RAS operator (dia_vals_solve_lc, weight "
             f"{oras._oras_c}), {C} blocks per subdomain ({var} memory): max "
             f"abs err {err:.3e} <= {tol:.3e}, iterations within {d_it} <= 1")
    Sx, Kx, Rx = p3["dia_vals_solve_lc"].shape
    bound, by = _k3_bound(got.iters, Sx, Kx, Rx)
    r3, l3 = counted(oras.run)
    cpu3 = RASolver(decompose(A3, b3, s3, 16), device="cpu").run()
    print(f"O-RAS 128^2, S = 16, overlap 6, weight {oras._oras_c}: card "
          f"{r3.iters} iterations (true rel {r3.relative_residual_norm:.3e},"
          f" run loop {r3.solve_time_s:.3f} s), CPU {cpu3.iters} (true rel "
          f"{cpu3.relative_residual_norm:.3e}); launches {l3}", flush=True)
    if r3.iters != cpu3.iters:
        for who, h in (("card", r3), ("CPU", cpu3)):
            print(f"O-RAS {who} history: " + " ".join(
                f"{v:.9e}" for v in h.global_resnorm_history), flush=True)
    n = min(len(r3.global_resnorm_history), len(cpu3.global_resnorm_history))
    rel = float(np.abs(r3.global_resnorm_history[:n]
                       / cpu3.global_resnorm_history[:n] - 1).max())
    sm.check(r3.converged and cpu3.converged
             and abs(r3.iters - cpu3.iters) <= 1 and rel <= 1e-3
             and r3.relative_residual_norm < 1e-7
             and l3["fused_cg"] == r3.iters,
             f"O-RAS through K3 converges on card and CPU: {r3.iters} / "
             f"{cpu3.iters} iterations, histories within {rel:.3e} <= 1e-3, "
             f"K3 launched once per local solve ({l3['fused_cg']})")
    sm.kernels["fused_cg_oras"] = dict(
        max_abs_err=err, cluster=C, variant=var, launches=l3["fused_cg"],
        ms=sm.ms(lambda: fused_cg_solve(*K3_args), 5),
        plain_ms=sm.ms(lambda: fused_cg_solve_plain(*K3_args), 2),
        bound_ms=bound, bound_by=by, library_ms=None)
    del oras, p3

    # --- 23. two-level free-running refinement: card against CPU -------------
    A4 = laplacian_2d(64)
    b4 = np.ones(A4.n)
    kw = dict(overlap=2, tolerance=1e-4, staleness=1, ninner=20,
              chunk_rounds=16, num_ranks=8)
    (x_c, i_c), l4 = counted(lambda: AsyncRASolver(A4, b4, 8, **kw)
                             .run_refined(tol=1e-8, max_rounds=800,
                                          coarse_q=4))
    x_h, i_h = AsyncRASolver(A4, b4, 8, device="cpu", **kw).run_refined(
        tol=1e-8, max_rounds=800, coarse_q=4)
    print(f"run_refined(tol=1e-8, coarse_q=4), 64^2, 8 ranks: card "
          f"{i_c['restarts']} restarts, {i_c['rounds']} rounds, true rel "
          f"{i_c['relative_residual_norm']:.6e}; CPU {i_h['restarts']} "
          f"restarts, true rel {i_h['relative_residual_norm']:.6e}; K5 "
          f"launches {l4['async_ras']}", flush=True)
    sm.check(i_c["converged"] and i_c["relative_residual_norm"] <= 1e-8
             and i_c["restarts"] == i_h["restarts"]
             and abs(i_c["relative_residual_norm"]
                     / i_h["relative_residual_norm"] - 1) <= 1e-6
             and l4["async_ras"] > 0,
             "two-level run_refined reaches 1e-8 on the card with the CPU "
             "run's restarts and residual, through K5")
    # the same through solve()'s free-running dispatch
    r5 = solve(A4, b4, Settings(free_running=True, two_level=True,
                                coarse_aggregates=4, tolerance=1e-8,
                                overlap=2, local_max_iters=20,
                                max_iters=800), 8)
    sm.check(r5.converged and r5.relative_residual_norm <= 1e-8,
             f"solve(free_running, two_level): true relative residual "
             f"{r5.relative_residual_norm:.3e} <= 1e-8")
    os.environ.pop("SCHWARZ_TPU_COARSE_CACHE")


# the reference's measured campaign (BASELINE.md "Paper-campaign run config",
# run_script:6-56): METIS into 16 parts, overlap 8, GMRES locals (restart
# 40, local tolerance 0.1, at most 70 iterations) with block-Jacobi,
# decentralized detection, tolerance 1e-8, float64.  The local operator is
# DIA plus its ELL remainder, which "auto" picks on the card (71% of the
# nonzeros on the diagonals); the CPU side takes it too, so both run the
# same local operator
def campaign_settings(max_iters: int):
    from schwarz_tpu_torch import (ConvergenceSettings, GlobalConvergence,
                                   LocalSolver, Partition, Precond, Settings)

    return Settings(
        partition=Partition.metis, overlap=8, dtype="float64",
        row_pad_multiple=128, local_solver=LocalSolver.iterative_gmres,
        restart_iter=40, local_tolerance=0.1, local_max_iters=70,
        precond=Precond.block_jacobi,
        convergence=ConvergenceSettings(
            method=GlobalConvergence.decentralized),
        tolerance=1e-8, max_iters=max_iters, spmv_format="dia")


# dense Cholesky locals applied through the explicit inverse, under FGMRES:
# 8 x 8 regular blocks, overlap 4, tolerance 1e-8; the DIA operator (95%
# of the nonzeros) on both sides, as for the campaign
def direct_settings(**kw):
    from schwarz_tpu_torch import LocalSolver, Partition, Settings

    return Settings(**{**dict(
        partition=Partition.regular2d, overlap=4, dtype="float64",
        row_pad_multiple=128, local_solver=LocalSolver.direct_cholesky,
        direct_apply="inverse", accelerator="fgmres", restart_iter=30,
        tolerance=1e-8, max_iters=600, spmv_format="dia"), **kw})


CAMPAIGN_ITERS = 30          # the 512^2 campaign run (it does not converge)
DIRECT_SMALL = (128, 16)     # the reduced size of the direct-locals phase


def _within_f64(h, want) -> float:
    """The float64 bar's reading: the largest of |h - want| / (1e-8 |want|
    + 1e-12 max |want|); at most 1 passes (rtol 1e-8, atol 1e-12 of the
    largest entry)."""
    import numpy as np

    if len(h) != len(want):
        return float("inf")
    return float((np.abs(h - want) / (1e-8 * np.abs(want)
                                      + 1e-12 * np.abs(want).max())).max())


def campaign_phases(sm: Smoke) -> None:
    """Phase 24: the reference's campaign configuration at full width
    (``laplacian_2d(512)``, native METIS into 16 parts, GMRES locals),
    30 outer iterations on the card against the port's CPU run of the same
    partition, then the converging 128^2 gate.  Each host cuts its own METIS
    partition, so the CPU runs are made here, on the card's host."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import RASolver
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    A = laplacian_2d(512)
    b = generate_rhs(A.n)
    s = campaign_settings(CAMPAIGN_ITERS)
    t0 = time.perf_counter()
    dec = decompose(A, b, s, 16)
    t_dec = time.perf_counter() - t0
    solver = RASolver(dec)
    torch.cuda.synchronize()
    m = solver.meta
    print(f"campaign 512^2 setup on the host: METIS + decompose (native) "
          f"{t_dec:.2f} s; R_int={m.max_interior} R_rows={m.max_rows} "
          f"R_ext={m.max_ext}, DIA offsets {solver._dia_offsets}, remainder "
          f"{solver._dia_has_remainder}", flush=True)
    res, launches = counted(solver.run)
    warm = solver.run()
    n_run = len(res.global_resnorm_history)
    inner = res.inner_iters_history
    ms_it = 1e3 * warm.solve_time_s / n_run
    cpu = RASolver(dec, device="cpu").run()
    print(f"campaign 512^2 on the card: {n_run} outer iterations "
          f"(converged={res.converged}), run loop {res.solve_time_s:.3f} s "
          f"cold, {warm.solve_time_s:.3f} s warm ({ms_it:.2f} ms per warm "
          f"outer iteration); inner iterations per outer iteration (max over "
          f"subdomains) {inner.max(axis=1).tolist()}, mean "
          f"{inner.mean():.2f}; K1 {launches['dia_spmv']} launches "
          f"({launches['dia_spmv'] / n_run:.1f} per outer iteration), K2 "
          f"{launches['halo_runs']} ({launches['halo_runs'] / n_run:.1f}); "
          f"the CPU run of the same partition {cpu.solve_time_s:.1f} s",
          flush=True)
    h = res.global_resnorm_history
    bar = _within_f64(h, cpu.global_resnorm_history)
    sm.check(bool(np.isfinite(h).all()) and res.solution.shape == (A.n,)
             and launches["dia_spmv"] > 0
             and launches["halo_runs"] == n_run
             and np.array_equal(inner, cpu.inner_iters_history)
             and bar <= 1,
             f"campaign 512^2: card and CPU inner iteration counts equal, "
             f"global histories within the float64 bar ({bar:.3f} <= 1 of "
             f"rtol 1e-8 + 1e-12 max), K1 launched, K2 once per outer "
             f"iteration")
    e1 = k1_entry(sm, solver._dia_offsets, solver._plan["dia_vals"],
                  torch.randn((16, m.max_ext), device="cuda",
                              dtype=torch.float64)[:, :m.max_rows],
                  f"at the campaign's {tuple(solver._plan['dia_vals'].shape)}")
    e1["launches"] = launches["dia_spmv"]
    e2 = k2_entry(sm, solver, "at the campaign's shapes")
    e2["launches"] = launches["halo_runs"]
    sm.kernels["dia_spmv_campaign"], sm.kernels["halo_runs_campaign"] = e1, e2
    for k, e in (("K1", e1), ("K2", e2)):
        print(f"{k} campaign: ms={e['ms']:.5f} plain_ms={e['plain_ms']:.5f} "
              f"bound_ms={e['bound_ms']:.5f} ({e['bound_by']}) library_ms="
              f"{e['library_ms']:.5f}", flush=True)
    del solver, dec

    # the converging gate at 128^2 (the JAX package counted 382 on a CPU)
    A2 = laplacian_2d(128)
    dec2 = decompose(A2, generate_rhs(A2.n), campaign_settings(1000), 16)
    g, lg = counted(RASolver(dec2).run)
    gc = RASolver(dec2, device="cpu").run()
    print(f"campaign 128^2: card {g.iters} iterations (true relative "
          f"residual {g.relative_residual_norm:.6e}, run loop "
          f"{g.solve_time_s:.2f} s), CPU {gc.iters} "
          f"({gc.relative_residual_norm:.6e}, {gc.solve_time_s:.1f} s); "
          f"launches {lg}", flush=True)
    sm.check(g.converged and g.iters == gc.iters and gc.converged
             and g.relative_residual_norm < 1e-7
             and lg["dia_spmv"] > 0 and lg["halo_runs"] > 0,
             f"campaign 128^2 detects at the CPU's count ({g.iters} / "
             f"{gc.iters})")


def direct_phases(sm: Smoke) -> None:
    """Phase 25: dense Cholesky locals through the explicit inverse under
    FGMRES at full width (``laplacian_2d(512)``, 8 x 8 blocks), then the
    reduced size against the CPU and the other direct applies."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import CommSettings, LocalSolver, RASolver
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
    from schwarz_tpu_torch.solvers.direct import inverse_apply

    A = laplacian_2d(512)
    b = generate_rhs(A.n)
    s = direct_settings()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dec = decompose(A, b, s, 64)
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = RASolver(dec)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated() / 1e9
    m = solver.meta
    inv = solver._plan["factor_inv"]
    fs = solver.factor_seconds
    print(f"direct 512^2, 64 subdomains: decompose {t_dec:.2f} s, plan "
          f"{t_plan:.2f} s of which factor {fs['factor']:.3f} s and inverse "
          f"{fs['inverse']:.3f} s; R_int={m.max_interior} R_rows={m.max_rows} "
          f"R_ext={m.max_ext}; inverse {tuple(inv.shape)} "
          f"{inv.numel() * 8 / 1e9:.2f} GB; peak device memory of the setup "
          f"{peak_setup:.2f} GB", flush=True)
    res, launches = counted(solver.run_accelerated)
    n_it = max(res.iters, 1)
    print(f"direct 512^2 under FGMRES(30): {res.iters} iterations, true "
          f"relative residual {res.relative_residual_norm:.6e}, run loop "
          f"{res.solve_time_s:.3f} s ({1e3 * res.solve_time_s / n_it:.3f} ms "
          f"per FGMRES iteration); K1 {launches['dia_spmv']} launches, K2 "
          f"{launches['halo_runs']}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    sm.check(res.converged and res.relative_residual_norm <= 1e-8
             and bool(np.isfinite(res.solution).all())
             and launches["dia_spmv"] > 0
             and launches["halo_runs"] >= 2 * res.iters,
             f"direct 512^2 converges under FGMRES: true relative residual "
             f"{res.relative_residual_norm:.3e} <= 1e-8 in {res.iters} "
             f"iterations, K1 and K2 (two exchanges an iteration) launched")
    r = solver._plan["local_rhs"]
    apply_ms = sm.ms(lambda: inverse_apply(inv, r), 10)
    bound, _ = _bound_ms(inv.numel() * 8 + 2 * r.numel() * 8,
                         2 * inv.numel(), "float64")
    print(f"direct 512^2: one preconditioner apply (batched product with "
          f"the inverse) {apply_ms:.3f} ms, bound {bound:.3f} ms (bytes)",
          flush=True)
    e1 = k1_entry(sm, solver._dia_offsets, solver._plan["dia_vals"],
                  torch.randn((64, m.max_ext), device="cuda",
                              dtype=torch.float64)[:, :m.max_rows],
                  f"at the direct phase's "
                  f"{tuple(solver._plan['dia_vals'].shape)}")
    e1["launches"] = launches["dia_spmv"]
    e2 = k2_entry(sm, solver, "at the direct phase's shapes")
    e2["launches"] = launches["halo_runs"]
    sm.kernels["dia_spmv_direct"], sm.kernels["halo_runs_direct"] = e1, e2
    del solver, dec, inv, r
    torch.cuda.empty_cache()

    # the reduced size: card against CPU, then the other applies
    n, S = DIRECT_SMALL
    A2 = laplacian_2d(n)
    b2 = generate_rhs(A2.n)
    dec2 = decompose(A2, b2, s, S)
    rs = RASolver(dec2).run_accelerated()
    rh = RASolver(dec2, device="cpu").run_accelerated()
    bar = _within_f64(rs.global_resnorm_history, rh.global_resnorm_history)
    sm.check(rs.converged and rs.iters == rh.iters and bar <= 1,
             f"direct {n}^2 on {S} subdomains under FGMRES: card {rs.iters} "
             f"/ CPU {rh.iters} iterations, histories within the float64 "
             f"bar ({bar:.3f} <= 1)")
    stat = {}
    variants = {
        "inverse": {}, "trisolve": dict(direct_apply="trisolve"),
        "blocked": dict(direct_apply="blocked"),
        "lu": dict(local_solver=LocalSolver.direct_lu,
                   direct_apply="trisolve"),
        "inverse+overlap_split": dict(comm=CommSettings(overlap_split=True))}
    for name, kw in variants.items():
        st = direct_settings(accelerator="none", **kw)
        rv, lv = counted(RASolver(decompose(A2, b2, st, S)).run)
        stat[name] = rv
        base = stat["inverse"]
        bar = _within_f64(rv.global_resnorm_history,
                          base.global_resnorm_history)
        sm.check(rv.converged and rv.iters == base.iters and bar <= 1
                 and lv["halo_runs"] == rv.iters + 1,
                 f"direct {n}^2 stationary, {name}: {rv.iters} iterations "
                 f"({base.iters} with the inverse), history within the "
                 f"float64 bar of the inverse run's ({bar:.3f} <= 1), run "
                 f"loop {rv.solve_time_s:.2f} s")

    # --- 26. checkpoints on the card: stopped early, resumed, bit for bit --
    full = RASolver(decompose(A2, b2, direct_settings(restart_iter=10), S))
    short = RASolver(decompose(A2, b2, direct_settings(restart_iter=10,
                                                       max_iters=10), S))
    ck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "smoke_checkpoint.npz")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    short.run(checkpoint_path=ck)
    r0 = full.run()
    r1 = full.run(resume_state=full.load_checkpoint(ck))
    a_short = short.run_accelerated(checkpoint_path=ck)
    a0 = full.run_accelerated()
    a1 = full.run_accelerated(resume_state=full.load_accel_checkpoint(ck))
    os.remove(ck)
    same = [np.array_equal(x.global_resnorm_history,
                           y.global_resnorm_history)
            and np.array_equal(x.solution, y.solution)
            for x, y in ((r1, r0), (a1, a0))]
    sm.check(all(same) and r0.converged and a0.converged
             and a_short.iters == 10,
             f"checkpoints on the card: the stationary run stopped at 10 of "
             f"{r0.iters} iterations and FGMRES(10) at 10 of {a0.iters}, each "
             f"resumed, equal the uninterrupted runs bit for bit ({same})")


def native_setup_phase(sm: Smoke) -> None:
    """Phase 27: the partition and decompose of the general slice
    (``anisotropic_diffusion_2d(360)``, METIS into 128 parts, overlap 2)
    with the native library and with the Python loops: bit-identical, both
    timed on the card's host."""
    import numpy as np

    from schwarz_tpu_torch import Partition, Settings, native
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.core.partition import make_partition
    from schwarz_tpu_torch.models import anisotropic_diffusion_2d

    A = anisotropic_diffusion_2d(360, eps=5.0, theta=0.3)
    b = np.ones(A.n)
    s = Settings(partition=Partition.metis, overlap=2)
    out = {}
    for tag in ("native", "python"):
        if tag == "python":
            os.environ["SCHWARZ_TPU_NATIVE"] = "0"
        native.reset()
        try:
            sm.check(native.available() == (tag == "native"),
                     f"the {tag} setup path is the one taken")
            t0 = time.perf_counter()
            part = make_partition(A, 128, s)
            t1 = time.perf_counter()
            dec = decompose(A, b, s, 128, partition_indices=part)
            t2 = time.perf_counter()
        finally:
            os.environ.pop("SCHWARZ_TPU_NATIVE", None)
            native.reset()
        out[tag] = (part, dec, t1 - t0, t2 - t1)
    (pn, dn, tpn, tdn), (pp, dp, tpp, tdp) = out["native"], out["python"]
    fields = ("perm", "first_row", "rows_count", "ghost_count",
              "local_to_global", "lmat_cols", "lmat_vals", "imat_cols",
              "imat_vals", "iface_rows", "iface_cols", "iface_vals",
              "local_rhs", "halo_src", "halo_slots", "comm_matrix")
    same = np.array_equal(pn, pp) and all(
        np.array_equal(getattr(dn, f), getattr(dp, f)) for f in fields)
    print(f"native setup, general slice (129 600 rows, METIS into 128, "
          f"overlap 2) on the card's host: partition {tpn:.2f} s native / "
          f"{tpp:.2f} s Python, decompose {tdn:.2f} s / {tdp:.2f} s",
          flush=True)
    sm.check(same, "native and Python partitions and Decomposition arrays "
             "are bit-identical")


# phase 28's argv: the flagship recipe of bench.py:531-539 through the
# command line (it has no row_pad_multiple flag, so rows pad to 8)
CLI_FLAGSHIP = [
    "--set_1d_laplacian_size", "512", "--num_subdomains", "16", "--overlap",
    "6", "--set_tol", "1e-8", "--num_iters", "200", "--local_compute_dtype",
    "float32", "--local_tol", "1e-6", "--local_max_iters", "20",
    "--use_precond", "--precond", "fsai", "--two_level", "--coarse_space",
    "spectral", "--coarse_aggregates", "32", "--instrument",
    "--timings_file", "t.csv", "--write_iters_and_residuals",
    "--write_comm_data", "--baseline_direct"]
CLI_STAGES = ("boundary_exchange", "boundary_update", "convergence_check",
              "coarse_correction", "residual_recompute", "local_solve",
              "expand_local_vec")


def _json_line(text: str):
    """The CLI's one JSON line, or None."""
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if len(lines) == 1 else None


def _in_process_cli(argv, where):
    """``cli.main(argv)`` in ``where`` with its stdout and stderr captured
    (no CLI JSON line reaches this script's stdout): ``(rc, json, err)``."""
    import contextlib
    import io

    from schwarz_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(where)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        os.chdir(here)
    return rc, _json_line(out.getvalue()), err.getvalue()


def cli_flagship_phase(sm: Smoke) -> None:
    """Phase 28: ``python -m schwarz_tpu_torch`` on the flagship recipe, in
    a subprocess in a temporary directory, instrumented, with its CSV
    files; then ``RASolver.run()`` in this process on ``settings_from_args``
    of the same argv, with its launches counted."""
    import csv
    import tempfile

    import numpy as np

    from schwarz_tpu_torch import RASolver, cli
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    here = os.path.dirname(os.path.abspath(__file__))
    # phase 20 cached the 16 eigenbases of this partition: the CLI's setup
    # reads them, as a second run of the recipe would
    cache = os.path.join(here, "build", "coarse_cache")
    env = dict(os.environ, SCHWARZ_TPU_COARSE_CACHE=cache,
               PYTHONPATH=os.pathsep.join(
                   p for p in (here, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "schwarz_tpu_torch", *CLI_FLAGSHIP],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=600)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = None, e.stdout or "", f"timed out: {e}"
        wall = time.perf_counter() - t0
        for ln in err.splitlines()[-12:]:
            print(f"  cli: {ln}", flush=True)
        res = _json_line(out)
        sm.check(rc == 0 and res is not None,
                 f"CLI subprocess on the flagship recipe: exit code {rc}, "
                 f"one JSON line on its stdout, {wall:.1f} s")
        if res is None:
            return
        sm.check(res["converged"] and res["relative_residual_norm"] <= 1e-8,
                 f"CLI flagship converged={res['converged']} in "
                 f"{res['iters']} iterations, relative residual "
                 f"{res['relative_residual_norm']:.6e} <= 1e-8")
        with open(os.path.join(tmp, "t.csv")) as f:
            rows = {r["func"]: r for r in csv.DictReader(f)}
        sm.check(set(rows) == set(CLI_STAGES),
                 f"t.csv holds the seven stage rows ({sorted(rows)})")
        files = sorted(f for f in os.listdir(tmp) if f.startswith("iter_res_"))
        n_rows = []
        for name in files:
            with open(os.path.join(tmp, name)) as f:
                n_rows.append(sum(1 for _ in f) - 1)
        passes = res["iters"] + 1       # the detecting pass has its row
        S = int(CLI_FLAGSHIP[CLI_FLAGSHIP.index("--num_subdomains") + 1])
        sm.check(files == [f"iter_res_{p:02d}.csv" for p in range(S)]
                 and all(n == passes for n in n_rows)
                 and os.path.exists(os.path.join(tmp, "comm_data.csv")),
                 f"{S} iter_res_XX.csv with one row per pass ({passes}: "
                 f"{sorted(set(n_rows))}) and a comm_data.csv")
    # the split of the loop by stage (host clock, synchronized per stage).
    # The CLI's one run is cold: a stage's first call pays one-time loads,
    # so the warm split takes each stage's median call times its calls
    it = max(res["iters"], 1)
    calls = {k: float(v["total"]) / float(v["avg"]) for k, v in rows.items()}
    warm = {k: float(rows[k]["med"]) * calls[k] / it for k in CLI_STAGES}
    loop = sum(float(v["total"]) for v in rows.values())
    print(f"flagship through the CLI, per-stage split of the instrumented "
          f"loop ({_card_line()}): {res['iters']} outer iterations, loop "
          f"{1e3 * res['solve_time_s']:.2f} ms (cold), stages "
          f"{1e3 * loop:.2f} ms, warm estimate "
          f"{1e3 * sum(warm.values()):.3f} ms per outer iteration", flush=True)
    print(f"  {'stage':20s} calls/it  med ms/call  warm ms/it  warm share  "
          f"cold ms/it", flush=True)
    for k in CLI_STAGES:
        print(f"  {k:20s} {calls[k] / it:8.2f} "
              f"{1e3 * float(rows[k]['med']):12.4f} {1e3 * warm[k]:11.4f} "
              f"{100 * warm[k] / sum(warm.values()):10.1f}% "
              f"{1e3 * float(rows[k]['total']) / it:10.4f}", flush=True)
    print(f"  {'outside the stages':20s} cold "
          f"{1e3 * (res['solve_time_s'] - loop) / it:.4f} ms per outer "
          f"iteration (host reads, histories)", flush=True)
    # run() in this process on the CLI's own Settings: the same count
    args = cli.build_parser().parse_args(CLI_FLAGSHIP)
    settings = cli.settings_from_args(args)
    A = laplacian_2d(args.set_1d_laplacian_size)
    os.environ["SCHWARZ_TPU_COARSE_CACHE"] = cache
    try:
        solver = RASolver(decompose(A, generate_rhs(A.n, random=False),
                                    settings, args.num_subdomains))
    finally:
        os.environ.pop("SCHWARZ_TPU_COARSE_CACHE")
    r, launches = counted(solver.run)
    del solver
    print(f"flagship iterations: CLI (run_instrumented) {res['iters']}, "
          f"in-process run() on settings_from_args {r.iters}, phase 20 "
          f"(row_pad_multiple 128, random rhs) "
          f"{getattr(sm, 'flagship_iters', None)}; run() launches "
          f"{launches}", flush=True)
    sm.check(r.converged and r.iters == res["iters"]
             and launches["dia_spmv"] > 0
             and launches["halo_runs"] == 2 * r.iters + 1
             and bool(np.isfinite(r.solution).all()),
             f"in-process run() on the CLI's Settings: {r.iters} iterations "
             f"= the CLI's {res['iters']}, K1 {launches['dia_spmv']} and K2 "
             f"{launches['halo_runs']} = 2 per outer iteration + 1")


def instrumented_phase(sm: Smoke, dec, settings) -> None:
    """Phase 29: ``run_instrumented`` against ``run()`` on phase 3's 1M-row
    slice (float32, K3), with the launches of each stage counted, and
    ``run_accelerated(instrument=True)`` on phase 25's 128^2 form."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import RASolver
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    solver = RASolver(dataclasses.replace(
        dec, settings=settings.replace(max_iters=5)))
    plain = solver.run()
    fns = _counters()
    calls = {}

    def counting(name, fn):
        def stage(*args):
            before = {k: f.launches for k, f in fns.items()}
            out = fn(*args)
            calls.setdefault(name, []).append(
                {k: f.launches - before[k] for k, f in fns.items()})
            return out
        return stage

    solver._stages.update({k: counting(k, f)
                           for k, f in solver._stages.items()})
    inst, launches = counted(solver.run_instrumented)
    del solver
    torch.cuda.empty_cache()
    h, hp = inst.global_resnorm_history, plain.global_resnorm_history
    gap = (float(np.abs(h / hp - 1).max()) if len(h) == len(hp)
           else float("inf"))
    avg_ms = {k: round(1e3 * v["avg"], 4)
              for k, v in inst.stage_timings.items()}
    print(f"instrumented on the 1M-row slice, 5 outer iterations: histories "
          f"against run() max rel diff {gap:.3e}; mean ms by stage "
          f"{avg_ms}; launches {launches}", flush=True)

    def each(name, kernel, want):
        got = [c[kernel] for c in calls.get(name, [])]
        others = [sum(v for k, v in c.items() if k != kernel)
                  for c in calls.get(name, [])]
        return bool(got) and all(want(g) for g in got), got, others

    ok_x, gx, ox = each("boundary_exchange", "halo_runs", lambda g: g == 1)
    ok_c, gc, _ = each("convergence_check", "dia_spmv", lambda g: g >= 1)
    ok_s, gs, os_ = each("local_solve", "fused_cg", lambda g: g == 1)
    sm.check(gap <= 1e-6 and len(h) == 5,
             f"run_instrumented equals run() on the card: {len(h)} entries, "
             f"max rel diff {gap:.3e} <= 1e-6")
    sm.check(ok_x and ok_c and ok_s and not any(ox) and not any(os_),
             f"each boundary_exchange launched K2 once {gx} (nothing else "
             f"{ox}), each convergence_check K1 {gc}, each local_solve K3 "
             f"once {gs} (nothing else {os_})")
    # FGMRES with dense Cholesky locals at phase 25's reduced size
    n, S = DIRECT_SMALL
    A = laplacian_2d(n)
    r = RASolver(decompose(A, generate_rhs(A.n), direct_settings(), S)
                 ).run_accelerated(instrument=True)
    st = r.stage_timings or {}
    print(f"run_accelerated(instrument=True), {n}^2 on {S} subdomains: "
          f"{r.iters} iterations, " + ", ".join(
              f"{k} med {1e3 * v['med']:.4f} ms (min {1e3 * v['min']:.4f}, "
              f"max {1e3 * v['max']:.4f})" for k, v in st.items()),
          flush=True)
    sm.check(r.converged and set(st) == {"accel_matvec", "accel_precond"}
             and all(v["min"] > 0 for v in st.values()),
             "run_accelerated(instrument=True) converges and times "
             "accel_matvec and accel_precond")


def cli_branch_phase(sm: Smoke) -> None:
    """Phase 30: the CLI's free-running and one-sided fused branches
    in-process through ``cli.main``, with a profiled run, then the
    gather/scatter ops on the card and one probe of K2."""
    import tempfile

    import numpy as np
    import torch

    from schwarz_tpu_torch.ops import (GatherOp, gather_values,
                                       scatter_values)
    from schwarz_tpu_torch.ops import native_gate
    from schwarz_tpu_torch.ops.halo_kernel import (assemble_x_ext,
                                                   assemble_x_ext_plain,
                                                   build_segments)

    free = ["--set_1d_laplacian_size", "64", "--overlap", "2", "--set_tol",
            "1e-4", "--num_iters", "800", "--free_running", "--async_ninner",
            "20", "--async_chunk_rounds", "16"]
    # phase 10's configuration on 8 ranks, which the dispatch gives the
    # 2-D tier, and on 7, which it gives the 1-D tier
    for S, kernel, tier in ((8, "async_ras_2d", "AsyncRASolver2D"),
                            (7, "async_ras", "AsyncRASolver")):
        with tempfile.TemporaryDirectory() as tmp:
            (rc, res, err), launches = counted(lambda: _in_process_cli(
                free + ["--num_subdomains", str(S)], tmp))
        res = res or {"converged": False, "done_at": None,
                      "relative_residual_norm": float("nan")}
        sm.check(rc == 0 and res["converged"]
                 and f"free-running kernel: {tier}" in err
                 and launches[kernel] > 0,
                 f"CLI --free_running, 64^2 on {S} ranks: {tier}, exit "
                 f"{rc}, done_at {res['done_at']}, relative residual "
                 f"{res['relative_residual_norm']:.3e}, {kernel} launched "
                 f"{launches[kernel]} times")
    rd = ["--set_1d_laplacian_size", "32", "--num_subdomains", "4",
          "--overlap", "3", "--dtype", "float32", "--set_tol", "1e-5",
          "--comm_strategy", "rdma", "--fused_local_cg", "--local_tol",
          "1e-6", "--local_max_iters", "50", "--profile_dir", "prof"]
    with tempfile.TemporaryDirectory() as tmp:
        (rc, res, err), launches = counted(lambda: _in_process_cli(rd, tmp))
        trace = os.path.join(tmp, "prof", "trace.json")
        names = set()
        if os.path.exists(trace):
            with open(trace) as f:
                names = {e.get("name", "") for e in json.load(f).get(
                    "traceEvents", []) if e.get("cat") == "kernel"}
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
    found = {k: any(n in e for e in names) for k, n in (
        ("K4", "rdma_exchange_kernel"), ("K2", "assemble_kernel"),
        ("K3", "fused_cg_kernel"))}
    res = res or {"converged": False, "iters": -1,
                  "relative_residual_norm": float("nan")}
    sm.check(rc == 0 and res["converged"]
             and launches["rdma_shift"] == launches["halo_runs"] > 0
             and launches["fused_cg"] == res["iters"] and all(found.values()),
             f"CLI --comm_strategy rdma --fused_local_cg --profile_dir: exit "
             f"{rc}, {res['iters']} iterations, relative residual "
             f"{res['relative_residual_norm']:.3e}; launches K4 "
             f"{launches['rdma_shift']}, K2 {launches['halo_runs']}, K3 "
             f"{launches['fused_cg']}; the {size}-byte Chrome trace names "
             f"{found}")
    # the gather/scatter ops on the card against the CPU
    gen = np.random.default_rng(5)
    idx = torch.from_numpy(gen.integers(0, 4096, size=3000))
    uniq = torch.from_numpy(gen.permutation(4096)[:3000])
    frm = torch.from_numpy(gen.standard_normal(4096))
    into = torch.from_numpy(gen.standard_normal(4096))
    worst = 0.0
    for op in GatherOp:
        for num in (None, 1234):
            ix = uniq if op in (GatherOp.copy, GatherOp.avg) else idx
            for fn in (gather_values, scatter_values):
                cpu = fn(num, ix, frm, into, op)
                card = fn(num, ix.cuda(), frm.cuda(), into.cuda(), op).cpu()
                worst = max(worst, float((card - cpu).abs().max()))
    sm.check(worst <= 1e-12,
             f"gather_values / scatter_values, 4 ops x num None/1234, card "
             f"against CPU: max abs diff {worst:.3e} <= 1e-12")
    # one probe of K2 against its plain version: each of 4 rows takes its
    # window and the next row's first 64 entries as its halo
    S, R, E = 4, 1024, 1088
    segs, first = build_segments(
        np.zeros(S, np.int64), R, E, np.tile(np.arange(R, E), (S, 1)),
        ((np.arange(S)[:, None] + 1) % S) * R + np.arange(E - R)[None, :],
        S * R)
    x_own = torch.randn((S, R), device="cuda", dtype=torch.float64)
    native_gate.reset_cache()
    ok, why = native_gate.native_probe(
        ("K2", "smoke"), assemble_x_ext, x_own, x_own,
        torch.from_numpy(segs).cuda(), torch.from_numpy(first).cuda(), E,
        compare=assemble_x_ext_plain)
    sm.check(ok, f"native_probe of K2 against its plain version: ({ok}, "
             f"{why})")


# phase 31: the flagship on 2 processes, the JAX multi-process worker's
# configuration on 4 (tests/distributed_worker.py:46-50, 79-81) at 16 ranks
MESH_RANKS = 16
# the 2-process flagship's history against phase 20's, both on the card:
# each process's batched products and sums run over 8 subdomains instead
# of 16 and may add in another order.  Read 1.106e-7 after the first outer
# iteration and 5.128e-4 over the 19 entries on an H100; gated at twice
# that
MESH_FIRST_RTOL = 2.2e-7
MESH_HISTORY_RTOL = 1e-3
# (name, n, two-level, float32 locals through K3)
MESH_WORKER_RUNS = (("one-level 64^2", 64, False, False),
                    ("two-level 64^2", 64, True, False),
                    ("two-level 256^2", 256, True, False),
                    ("two-level 64^2, K3 locals", 64, True, True))


def mesh_worker_settings(two_level: bool, fused: bool = False):
    from schwarz_tpu_torch import (CommSettings, HaloStrategy, Precond,
                                   Settings)

    s = Settings(overlap=3, tolerance=1e-7, max_iters=3000, dtype="float64",
                 comm=CommSettings(strategy=HaloStrategy.neighbor))
    if two_level:
        s = s.replace(two_level=True, coarse_aggregates=2,
                      coarse_space="spectral", coarse_solver="cg")
    if fused:
        s = s.replace(local_compute_dtype="float32", spmv_format="dia",
                      row_pad_multiple=128, fused_local_cg=True,
                      precond=Precond.jacobi, local_tolerance=1e-6)
    return s


def _mesh_run(mesh, fn):
    """``fn()`` with its launches counted and the mesh's traffic read: the
    result, the launches, and the mesh's calls, host seconds and bytes."""
    mesh.stats.update(calls=0, seconds=0.0, wait_seconds=0.0, bytes=0)
    res, launches = counted(fn)
    return res, launches, dict(mesh.stats)


def _mesh_record(res, launches, stats) -> dict:
    n = max(len(res.global_resnorm_history), 1)
    return {"iters": res.iters, "converged": bool(res.converged),
            "rel": res.relative_residual_norm,
            "hist": res.global_resnorm_history.tolist(),
            "inner": res.inner_iters_history.tolist(),
            "solution_norm": float((res.solution ** 2).sum() ** 0.5),
            "finite": bool((res.solution == res.solution).all()),
            "ms_it": 1e3 * res.solve_time_s / n,
            "comm_ms_it": 1e3 * stats["seconds"] / n,
            "comm_wait_ms_it": 1e3 * stats["wait_seconds"] / n,
            "comm_calls_it": stats["calls"] / n,
            "comm_bytes_it": stats["bytes"] / n,
            "launches": launches}


def _mesh_child_flagship(mesh) -> dict:
    """Phase 31 (a) in one process: the flagship's solver on this
    process's 8 strips, a cold run counted, a warm run timed."""
    import torch

    from schwarz_tpu_torch import Partition, Precond, RASolver, Settings
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    A = laplacian_2d(512)
    b = generate_rhs(A.n)
    s = Settings(partition=Partition.regular, precond=Precond.fsai,
                 **FLAGSHIP)
    t0 = time.perf_counter()
    solver = RASolver(decompose(A, b, s, MESH_RANKS), mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cold = _mesh_record(*_mesh_run(mesh, solver.run))
    warm = _mesh_record(*_mesh_run(mesh, solver.run))
    return {"setup_s": setup_s, "cold": cold, "warm": warm,
            "block": [mesh.block(MESH_RANKS).start,
                      mesh.block(MESH_RANKS).stop]}


def _mesh_child_worker(mesh) -> dict:
    """Phase 31 (b) in one process: MESH_WORKER_RUNS through ``solve``."""
    from schwarz_tpu_torch import solve
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    out = {}
    for name, n, two, fused in MESH_WORKER_RUNS:
        A = laplacian_2d(n)
        b = generate_rhs(A.n, random=False)
        s = mesh_worker_settings(two, fused)
        out[name] = _mesh_record(*_mesh_run(
            mesh, lambda: solve(A, b, s, mesh=mesh)))
    return out


def mesh_child(argv) -> int:
    """One process of a phase 31 group: ``--mesh-child CASE DIR PID NPROC
    PORT``; writes its result to DIR/p<PID>.json."""
    import traceback

    case, out_dir, pid, nproc, port = (argv[0], argv[1], int(argv[2]),
                                       int(argv[3]), argv[4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from schwarz_tpu_torch.parallel import mesh as pmesh

    try:
        pmesh.initialize(f"localhost:{port}", nproc, pid, timeout_s=240)
        mesh = pmesh.make_mesh(num_ranks=MESH_RANKS)
        if case == "async":
            res = _mesh_child_async(mesh, out_dir)
        else:
            res = {"flagship": _mesh_child_flagship,
                   "worker": _mesh_child_worker}[case](mesh)
        with open(os.path.join(out_dir, f"p{pid}.json"), "w") as f:
            json.dump(res, f)
        pmesh.shutdown()
    except Exception:                     # noqa: BLE001 - the parent reads it
        traceback.print_exc()
        return 1
    return 0


def _mesh_group(case: str, nproc: int, timeout_s: float) -> list:
    """Run phase 31's ``case`` in ``nproc`` child processes of this script
    (the kernels are built: the children load them); their results in
    process order.  The first child to fail, or a group outlasting
    ``timeout_s``, has every child killed, and the call raises with the
    ends of their logs (``mesh.launch``)."""
    import shutil

    from schwarz_tpu_torch.parallel import mesh as pmesh

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "mesh_runs", case)
    shutil.rmtree(tmp, ignore_errors=True)
    pmesh.launch([sys.executable, os.path.abspath(__file__), "--mesh-child",
                  case, tmp], nproc, tmp, timeout_s)
    outs = []
    for pid in range(nproc):
        with open(os.path.join(tmp, f"p{pid}.json")) as f:
            outs.append(json.load(f))
    return outs


def _same_everywhere(outs, *keys) -> bool:
    """Whether every process's ``o[k0][k1]...`` equals process 0's."""
    def get(o):
        for k in keys:
            o = o[k]
        return o
    return all(get(o) == get(outs[0]) for o in outs[1:])


def mesh_phases(sm: Smoke) -> None:
    """Phase 31: the synchronous solve across processes on the one card,
    and the first example on the card."""
    import numpy as np
    import torch

    from schwarz_tpu_torch import solve
    from schwarz_tpu_torch.examples import poisson_basic
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    here = os.path.dirname(os.path.abspath(__file__))
    # the flagship's bases are in phase 20's cache; the children inherit it
    os.environ["SCHWARZ_TPU_COARSE_CACHE"] = os.path.join(
        here, "build", "coarse_cache")
    torch.cuda.empty_cache()
    card = _card_line()

    # --- (a) the flagship on 2 processes ------------------------------------
    t0 = time.perf_counter()
    outs = _mesh_group("flagship", 2, 600)
    t_a = time.perf_counter() - t0
    want_it = getattr(sm, "flagship_iters", 18)
    h20 = np.asarray(getattr(sm, "flagship_hist", []))
    for pid, o in enumerate(outs):
        c, w = o["cold"], o["warm"]
        lo, hi = o["block"]
        n_inner = np.asarray(c["inner"])[:c["iters"], lo:hi].max(axis=1)
        k1_rate = 2 * c["iters"] + 1 + 2 * int((n_inner + 1).sum())
        o["k1_rate"] = k1_rate
        print(f"flagship, process {pid} of 2 (subdomains {lo}-{hi - 1}): "
              f"setup {o['setup_s']:.2f} s, {c['iters']} iterations, true "
              f"relative residual {c['rel']:.6e}; warm {w['ms_it']:.2f} ms "
              f"per outer iteration (phase 20 in one process: "
              f"{getattr(sm, 'flagship_ms_it', float('nan')):.2f}), of "
              f"which cross-process traffic {w['comm_ms_it']:.3f} ms of "
              f"host time ({w['comm_wait_ms_it']:.3f} of it waiting for the "
              f"card's queued work) in {w['comm_calls_it']:.1f} collectives "
              f"({w['comm_bytes_it'] / 1e3:.1f} KB); cold {c['ms_it']:.2f} "
              f"ms, traffic {c['comm_ms_it']:.3f}; launches {c['launches']}"
              f" (K1 at phase 20's rate: {k1_rate}); {card}", flush=True)
    c0 = outs[0]["cold"]
    h = np.asarray(c0["hist"])
    sm.mesh_flagship_hist = h               # phase 34 resumes to it
    if len(h) == len(h20) and len(h) > 1:
        gaps = np.abs(h / h20 - 1)
        first, over = float(gaps[1]), float(gaps.max())
    else:
        first = over = float("inf")
    print("flagship on 2 processes, history: " + " ".join(
        f"{v:.9e}" for v in h), flush=True)
    print(f"flagship on 2 processes against phase 20's card history: "
          f"{first:.3e} after the first outer iteration, {over:.3e} over "
          f"the history; phase (a) took {t_a:.1f} s", flush=True)
    sm.check(_same_everywhere([o["cold"] for o in outs], "hist")
             and _same_everywhere([o["cold"] for o in outs], "iters")
             and c0["iters"] == want_it and c0["converged"]
             and c0["rel"] <= 1e-8 and c0["finite"],
             f"flagship on 2 processes: {c0['iters']} iterations (phase "
             f"20: {want_it}), true relative residual {c0['rel']:.3e} <= "
             f"1e-8, the same result in every process")
    sm.check(first <= MESH_FIRST_RTOL and over <= MESH_HISTORY_RTOL,
             f"flagship on 2 processes against phase 20's card history: "
             f"{first:.3e} <= {MESH_FIRST_RTOL:g} after the first outer "
             f"iteration, {over:.3e} <= {MESH_HISTORY_RTOL:g} over it")
    sm.check(all(o["cold"]["launches"]["dia_spmv"] == o["k1_rate"]
                 and o["cold"]["launches"]["halo_runs"]
                 == 2 * o["cold"]["iters"] + 1
                 and o["cold"]["launches"]["fused_cg"] == 0 for o in outs),
             "flagship on 2 processes: K1 and K2 launched in each process at "
             "phase 20's rate (K1 " + ", ".join(
                 f"{o['cold']['launches']['dia_spmv']} = {o['k1_rate']}"
                 for o in outs) + "; K2 " + ", ".join(
                 str(o["cold"]["launches"]["halo_runs"]) for o in outs)
             + " = 2 per outer iteration + the exit pass)")

    # --- (b) the JAX worker's configuration on 4 processes -------------------
    t0 = time.perf_counter()
    single = {}
    for name, n, two, fused in MESH_WORKER_RUNS:
        A = laplacian_2d(n)
        r = solve(A, generate_rhs(A.n, random=False),
                  mesh_worker_settings(two, fused), MESH_RANKS)
        single[name] = r
        n_run = max(len(r.global_resnorm_history), 1)
        print(f"{name}, 16 subdomains, one process on the card: {r.iters} "
              f"iterations, true relative residual "
              f"{r.relative_residual_norm:.3e}, "
              f"{1e3 * r.solve_time_s / n_run:.2f} ms per outer iteration",
              flush=True)
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = _mesh_group("worker", 4, 600)
    t_b = time.perf_counter() - t0
    for name, n, two, fused in MESH_WORKER_RUNS:
        per = [o[name] for o in outs]
        r0, ref = per[0], single[name]
        href = ref.global_resnorm_history
        hm = np.asarray(r0["hist"])
        gap = (float(np.max(np.abs(hm - href)) / href.max())
               if len(hm) == len(href) else float("inf"))
        for pid, r in enumerate(per):
            print(f"{name}, process {pid} of 4: warm-up included "
                  f"{r['ms_it']:.2f} ms per outer iteration, of which "
                  f"cross-process traffic {r['comm_ms_it']:.3f} ms of host "
                  f"time ({r['comm_wait_ms_it']:.3f} of it waiting for the "
                  f"card's queued work) in {r['comm_calls_it']:.1f} "
                  f"collectives "
                  f"({r['comm_bytes_it'] / 1e3:.1f} KB); launches "
                  f"{r['launches']}", flush=True)
        sm.check(_same_everywhere(per, "hist") and r0["converged"]
                 and r0["iters"] == ref.iters and r0["rel"] < 1e-5
                 and all(r["launches"]["halo_runs"] > 0
                         and r["launches"]["dia_spmv"] > 0
                         and (r["launches"]["fused_cg"] > 0) == fused
                         for r in per),
                 f"{name} on 4 processes x 4 subdomains (neighbor, float64,"
                 f" tolerance 1e-7): {r0['iters']} iterations, the single-"
                 f"process card run's {ref.iters}, true relative residual "
                 f"{r0['rel']:.3e} < 1e-5, the same in every process, K1 and "
                 f"K2{' and K3' if fused else ''} launched in each; history "
                 f"within {gap:.3e} of the largest entry of the "
                 f"single-process one")
    it1 = outs[0]["one-level 64^2"]["iters"]
    it2 = outs[0]["two-level 64^2"]["iters"]
    sm.check(it2 <= it1,
             f"two-level on 4 processes takes no more iterations than "
             f"one-level at 64^2 ({it2} <= {it1})")
    print(f"phase 31 (b): single-process runs {t_single:.1f} s, the "
          f"4-process group {t_b:.1f} s; {card}", flush=True)

    # --- the first example on the card --------------------------------------
    res, launches = counted(poisson_basic.main)
    sm.check(res.converged and res.relative_residual_norm <= 1e-8
             and launches["dia_spmv"] > 0 and launches["halo_runs"] > 0,
             f"examples.poisson_basic on the card: {res.iters} iterations, "
             f"true relative residual {res.relative_residual_norm:.3e}, "
             f"launches {launches}")
    os.environ.pop("SCHWARZ_TPU_COARSE_CACHE")

# phases 32-34: the one-sided exchange, the free-running tiers and the
# checkpoints across 2 processes on the one card (one child group)
# phase 10's converging 1-D solve, phase 13's 2-D one, phase 16's general one
FREE10 = dict(overlap=2, tolerance=1e-4, staleness=1, ninner=20,
              chunk_rounds=16)
FREE13 = dict(px=4, py=2, tolerance=2e-3, staleness=1, ninner=30,
              chunk_rounds=20)
FREE16 = dict(tolerance=1e-3, staleness=1, ninner=24, chunk_rounds=8)
FLAGSHIP_STOP = 9        # phase 34 stops the flagship here, then resumes
# phase 33: a slice's 2-process solution against one process's, relative
# to its largest entry: float32 rounding, carried over 64 rounds
SLICE_X_RTOL = 1e-5


def _slice_free_settings(**kw):
    """Phases 9, 12 and 15's free-running slices."""
    from schwarz_tpu_torch import CommSettings, Settings

    return Settings(free_running=True, overlap=2, tolerance=1e-4,
                    local_max_iters=16, max_iters=64,
                    comm=CommSettings(staleness=1), **kw)


def _k4_events_ms(rounds, x, reps: int = 20) -> float:
    """K4's mean device time per exchange on ``rounds``, CUDA events around
    each launch (across processes it includes waiting for the peer's)."""
    import torch

    from schwarz_tpu_torch.ops.rdma_kernel import (rdma_exchange_launch,
                                                   rdma_shift_finish)

    statuses, pairs = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, st = rdma_exchange_launch(x, rounds, None, "put")
        b.record()
        statuses.append(st)
        pairs.append((a, b))
    torch.cuda.synchronize()
    rdma_shift_finish(statuses)
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _free_record(x, info, launches=None) -> dict:
    import numpy as np

    out = {"x": np.asarray(x, np.float64).tolist(),
           "done_at": np.asarray(info["done_at"]).tolist(),
           "rounds": int(info["rounds"]), "time_s": info["time_s"],
           "rel": info["relative_residual_norm"],
           "converged": bool(info["converged"])}
    if launches is not None:
        out["launches"] = launches
    return out


def _mesh_child_async(mesh, out_dir: str) -> dict:
    """Phases 32-34 in one process of the 2-process group; the files it
    writes (the slices' solutions, the checkpoints) go to ``out_dir``, and
    their paths into the result."""
    import copy

    import numpy as np
    import torch

    from schwarz_tpu_torch import (CommSettings, HaloStrategy, Partition,
                                   Precond, RASolver, Settings, solve)
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.core.partition import make_partition
    from schwarz_tpu_torch.models import (anisotropic_diffusion_2d,
                                          generate_rhs, laplacian_2d,
                                          laplacian_3d, matrix_path,
                                          read_mtx)
    from schwarz_tpu_torch.ops.async_ras import AsyncRASolver
    from schwarz_tpu_torch.ops.async_ras_2d import AsyncRASolver2D
    from schwarz_tpu_torch.ops.async_ras_2d_kernel import async_ras_2d_rounds
    from schwarz_tpu_torch.ops.async_ras_general import AsyncGeneralRASolver
    from schwarz_tpu_torch.ops.async_ras_general_kernel import (
        async_general_rounds)
    from schwarz_tpu_torch.ops.async_ras_kernel import async_ras_rounds
    from schwarz_tpu_torch.parallel import mesh as pmesh

    out = {"pid": mesh.process_index}
    t_phase = time.perf_counter()
    # --- 32. the one-sided exchange: phase 18's slice, then phase 19's ------
    A = laplacian_2d(1024)
    b = generate_rhs(A.n, random=False)
    settings = Settings(precond=Precond.jacobi, **SLICE)
    dec = decompose(A, b, settings, 16)
    for name, comm in (
            ("rdma", CommSettings(strategy=HaloStrategy.rdma,
                                  enable_put=True, enable_get=False)),
            ("neighbor", CommSettings(strategy=HaloStrategy.neighbor))):
        solver = RASolver(dataclasses.replace(
            dec, settings=settings.replace(comm=comm)), mesh=mesh)
        out[name] = {"cold": _mesh_record(*_mesh_run(mesh, solver.run)),
                     "warm": _mesh_record(*_mesh_run(mesh, solver.run))}
        if name == "rdma":
            rounds = solver._rounds
            x = torch.zeros((solver.S_local, solver.meta.max_interior),
                            dtype=torch.float32, device=solver.device)
            out["k4_ms"] = _k4_events_ms(rounds, x)
            out["k4_wait_ns"] = rounds._card.longest_wait_ns()
        del solver
    A2 = laplacian_2d(32)
    s19 = Settings(partition=Partition.regular2d, overlap=2, max_iters=1500,
                   tolerance=1e-6, comm=CommSettings(
                       strategy=HaloStrategy.rdma))
    out["get2d"] = _mesh_record(*_mesh_run(mesh, lambda: solve(
        A2, generate_rhs(A2.n, random=False), s19, 64, mesh=mesh)))
    out["t32"] = time.perf_counter() - t_phase

    # --- 33. the free-running tiers ------------------------------------------
    t_phase = time.perf_counter()
    m8 = pmesh.make_mesh(num_ranks=8)
    A64, A256 = laplacian_2d(64), laplacian_2d(256)
    s1 = AsyncRASolver(A64, np.ones(A64.n), 8, mesh=m8, **FREE10)
    out["free_1d"] = _free_record(*s1.run(max_rounds=800))
    out["free_1d"]["cluster"] = async_ras_rounds.cluster
    out["free_1d"]["wait_ns"] = async_ras_rounds.longest_wait_ns
    xr, ir = s1.run_refined(tol=1e-8, max_rounds=800)
    out["refined"] = {"rel": ir["relative_residual_norm"],
                      "restarts": ir["restarts"], "rounds": ir["rounds"]}
    s2 = AsyncRASolver2D(A256, np.ones(A256.n), mesh=m8, **FREE13)
    out["free_2d"] = _free_record(*s2.run(max_rounds=400))
    out["free_2d"]["cluster"] = async_ras_2d_rounds.cluster
    out["free_2d"]["wait_ns"] = async_ras_2d_rounds.longest_wait_ns
    ani3 = read_mtx(matrix_path("ani3_crop.mtx"))
    part = make_partition(ani3, 4, Settings(partition=Partition.metis))
    s3 = AsyncGeneralRASolver(ani3, np.ones(ani3.n), 4, overlap=2, part=part,
                              mesh=pmesh.make_mesh(num_ranks=4), **FREE16)
    out["free_general"] = _free_record(*s3.run(max_rounds=400))
    out["free_general"]["variant"] = async_general_rounds.variant
    out["free_general"]["wait_ns"] = async_general_rounds.longest_wait_ns
    # the slices of phases 9, 12 and 15 at full size, cold then warm
    A3 = laplacian_3d(100)
    Aa = anisotropic_diffusion_2d(360, eps=5.0, theta=0.3)
    sm_ = _slice_free_settings()
    smet = _slice_free_settings(partition=Partition.metis)
    part128 = make_partition(Aa, 128, smet)
    for name, mat, S, st, kw, kern in (
            ("slice_1d", A3, 16, sm_, {}, async_ras_rounds),
            ("slice_2d", A, 16, sm_, {}, async_ras_2d_rounds),
            ("slice_general", Aa, 128, smet,
             dict(partition_indices=part128), async_general_rounds)):
        mS = pmesh.make_mesh(num_ranks=S)
        rec, xs = {}, {}
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            res, launches = counted(lambda: solve(
                mat, np.ones(mat.n), st, S, mesh=mS, **kw))
            xs[tag] = res.solution
            rec[tag] = {"launches": launches, "run_s": res.solve_time_s,
                        "wall_s": time.perf_counter() - t0,
                        "rel": res.relative_residual_norm,
                        "finite": bool(np.isfinite(res.solution).all()),
                        "wait_ns": kern.longest_wait_ns}
        rec["cluster"] = getattr(kern, "cluster", None)
        rec["variant"] = getattr(kern, "variant", None)
        # the parent holds the cold solution against phase 9, 12 or 15's
        rec["warm_same_x"] = bool(np.array_equal(xs["warm"], xs["cold"]))
        rec["x_path"] = os.path.join(out_dir,
                                     f"{name}_p{mesh.process_index}.npy")
        np.save(rec["x_path"], xs["cold"])
        out[name] = rec
    out["t33"] = time.perf_counter() - t_phase

    # --- 34. checkpoints: the flagship stopped at FLAGSHIP_STOP, resumed -----
    t_phase = time.perf_counter()
    Af = laplacian_2d(512)
    sf = Settings(partition=Partition.regular, precond=Precond.fsai,
                  **FLAGSHIP)
    full = RASolver(decompose(Af, generate_rhs(Af.n), sf, MESH_RANKS),
                    mesh=mesh)
    half = copy.copy(full)
    half.settings = sf.replace(max_iters=FLAGSHIP_STOP)
    path = os.path.join(out_dir, "flagship_stop.npz")
    r = half.run(checkpoint_path=path)
    out["ck_path"] = path
    out["ck_stop_iters"] = r.iters
    res = full.run(resume_state=full.load_checkpoint(path))
    out["ck_resumed"] = {"iters": res.iters, "rel": res.relative_residual_norm,
                         "hist": res.global_resnorm_history.tolist(),
                         "converged": bool(res.converged)}
    del full, half
    fr = AsyncRASolver(A64, np.ones(A64.n), 8, mesh=m8, **FREE10)
    xs, i_s = fr.run(max_rounds=800)
    fpath = os.path.join(out_dir, "free_stop")
    fr.run(max_rounds=2 * FREE10["chunk_rounds"], checkpoint_path=fpath)
    xc, ic = fr.run(max_rounds=800, resume_state=fr.load_checkpoint(fpath))
    out["ck_free"] = {"same_x": bool(np.array_equal(xs, xc)),
                      "done_at": np.asarray(ic["done_at"]).tolist(),
                      "straight_done_at": np.asarray(i_s["done_at"]).tolist()}
    out["t34"] = time.perf_counter() - t_phase
    return out


def _mps_line() -> str:
    """Whether the card runs under the Multi-Process Service, and its
    compute mode (nvidia-smi)."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    mps = os.path.exists(os.path.join(pipe, "control"))
    return f"compute mode {mode}, MPS {'on' if mps else 'off'}"


def mesh_async_phases(sm: Smoke) -> None:
    """Phases 32-34: the one-sided exchange (K4), the free-running tiers
    (K5-K7) and the checkpoints across 2 processes on the one card, each
    process reaching the other's ranks through the CUDA IPC window."""
    import numpy as np

    from schwarz_tpu_torch import Partition, Precond, RASolver, Settings
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["SCHWARZ_TPU_COARSE_CACHE"] = os.path.join(
        here, "build", "coarse_cache")
    card = _card_line()
    print(f"phases 32-34 on 2 processes: {_mps_line()}; {card}", flush=True)
    t0 = time.perf_counter()
    outs = _mesh_group("async", 2, 900)
    print(f"phases 32-34: the 2-process group took "
          f"{time.perf_counter() - t0:.1f} s (phase 32 "
          f"{outs[0]['t32']:.1f} s, 33 {outs[0]['t33']:.1f} s, 34 "
          f"{outs[0]['t34']:.1f} s in process 0)", flush=True)

    # --- 32. the one-sided exchange across processes -------------------------
    k4_1p = sm.kernels["rdma_shift"]["ms"]
    for pid, o in enumerate(outs):
        rc, rw = o["rdma"]["cold"], o["rdma"]["warm"]
        print(f"phase 32, rdma slice, process {pid} of 2: {rc['iters']} "
              f"iterations, launches {rc['launches']}; warm "
              f"{rw['ms_it']:.2f} ms per outer iteration (neighbor "
              f"{o['neighbor']['warm']['ms_it']:.2f}); K4 {o['k4_ms']:.4f} "
              f"ms per exchange (events; phase 17 in one process: "
              f"{k4_1p:.4f}); longest K4 wait {o['k4_wait_ns'] / 1e6:.3f} "
              f"ms; {card}", flush=True)
    o0 = outs[0]
    n_it = len(o0["rdma"]["cold"]["hist"])
    sm.check(all(o["rdma"]["cold"]["launches"]["rdma_shift"] == n_it
                 and o["rdma"]["cold"]["launches"]["halo_runs"] == n_it
                 and o["neighbor"]["cold"]["launches"]["rdma_shift"] == 0
                 for o in outs) and n_it > 0,
             f"phase 32: K4 and K2 launched once per exchange in each "
             f"process ({n_it} exchanges)")
    sm.check(_same_everywhere(outs, "rdma", "cold", "hist")
             and o0["rdma"]["cold"]["hist"] == o0["neighbor"]["cold"]["hist"]
             and o0["rdma"]["warm"]["hist"] == o0["rdma"]["cold"]["hist"],
             "phase 32: the rdma slice on 2 processes gives the neighbor "
             "strategy's history on 2 processes bit for bit")
    want = getattr(sm, "rdma_get_iters", None)
    g = o0["get2d"]
    sm.check(_same_everywhere(outs, "get2d", "hist") and g["converged"]
             and g["iters"] == want and g["rel"] < 1e-5
             and all(o["get2d"]["launches"]["rdma_shift"] > 0 for o in outs),
             f"phase 32: laplacian_2d(32), regular2d, 64 subdomains on 16 "
             f"ranks, rdma get mode on 2 processes: {g['iters']} iterations "
             f"(phase 19 in one process: {want}), true relative residual "
             f"{g['rel']:.3e}")
    sm.kernels["rdma_shift"]["launches_2p"] = [
        o["rdma"]["cold"]["launches"]["rdma_shift"] for o in outs]
    sm.kernels["rdma_shift"]["ms_2p"] = [o["k4_ms"] for o in outs]
    sm.kernels["rdma_shift"]["wait_ms_2p"] = [o["k4_wait_ns"] / 1e6
                                              for o in outs]

    # --- 33. the free-running tiers across processes -------------------------
    for tier, key, bar in (("1d", "free_1d", 1e-3), ("2d", "free_2d", 1e-2),
                           ("general", "free_general", 5e-3)):
        x1, i1 = sm.free_refs[tier]
        r = o0[key]
        dx = float(np.abs(np.asarray(r["x"]) - x1).max())
        extra = {k: [o[key].get(k) for o in outs]
                 for k in ("cluster", "variant") if k in r}
        print(f"phase 33, {tier} on 2 processes: done_at {r['done_at']} in "
              f"{r['rounds']} rounds, {r['time_s']:.4f} s, true rel "
              f"{r['rel']:.6e}; one process on the card: done_at "
              f"{np.asarray(i1['done_at']).tolist()}, {i1['time_s']:.4f} s; "
              f"max |x_2p - x_1p| {dx:.3e}; {extra}; longest wait "
              f"{[o[key]['wait_ns'] / 1e6 for o in outs]} ms", flush=True)
        # without fresh_read the rounds do not depend on timing, and both
        # runs take one cluster size: x is the single process's bit for bit
        sm.check(_same_everywhere(outs, key, "x") and r["converged"]
                 and r["done_at"] == np.asarray(i1["done_at"]).tolist()
                 and dx == 0.0 and r["rel"] < bar,
                 f"phase 33, {tier} tier on 2 processes: done_at equal to "
                 f"the single-process card run's, x equal to it bit for bit "
                 f"(max |x_2p - x_1p| {dx:.3e}), true residual "
                 f"{r['rel']:.3e} < {bar:g}")
    rr = o0["refined"]
    sm.check(rr["rel"] <= 1e-8,
             f"phase 33: run_refined on 2 processes reaches "
             f"{rr['rel']:.3e} <= 1e-8 ({rr['restarts']} restarts)")
    for name, kern, phase, others in (
            ("slice_1d", "async_ras", 7, ("async_ras_2d",
                                          "async_ras_general")),
            ("slice_2d", "async_ras_2d", 11, ("async_ras",
                                              "async_ras_general")),
            ("slice_general", "async_ras_general", 14,
             ("async_ras", "async_ras_2d"))):
        per = [o[name] for o in outs]
        for pid, rec in enumerate(per):
            for tag in ("cold", "warm"):
                c = rec[tag]
                n_l = c["launches"][kern]
                print(f"phase 33, {name} ({tag}) process {pid}: {n_l} "
                      f"launches, run loop {c['run_s']:.4f} s = "
                      f"{1e3 * c['run_s'] / max(n_l, 1):.3f} ms per "
                      f"16-round launch (phase {phase} in one process, "
                      f"events: {sm.kernels[kern]['ms']:.3f}), wall "
                      f"{c['wall_s']:.2f} s, true rel {c['rel']:.6e}, "
                      f"longest wait {c['wait_ns'] / 1e6:.3f} ms, cluster "
                      f"{rec['cluster']}, variant {rec['variant']}",
                      flush=True)
        cold = [rec["cold"] for rec in per]
        sm.check(all(c["launches"][kern] > 0 and c["finite"]
                     and all(c["launches"][k] == 0 for k in others)
                     for c in cold)
                 and _same_everywhere(per, "cold", "launches"),
                 f"phase 33, {name} on 2 processes: {kern} launched "
                 f"{cold[0]['launches'][kern]} times in each process, the "
                 f"other tiers' kernels 0, finite results")
        # the slice's solution against the single-process run on the same
        # inputs: the rounds do not depend on timing, but the processes'
        # launches may take another cluster size than one process's, and
        # a rank's float64 sums are then grouped otherwise before their
        # rounding to float32 (async_common.cuh ClusterTeam)
        x1 = sm.slice_refs.get(name)
        gaps = [float("inf") if x1 is None else float(
            np.abs(np.load(rec["x_path"]) - x1).max()) for rec in per]
        scale = 0.0 if x1 is None else float(np.abs(x1).max())
        sm.check(x1 is not None and max(gaps) <= SLICE_X_RTOL * scale
                 and all(rec["warm_same_x"] for rec in per),
                 f"phase 33, {name} on 2 processes: each process's solution "
                 f"within {max(gaps):.3e} <= {SLICE_X_RTOL:g} x "
                 f"{scale:.4e} of the single-process run's on the same "
                 f"inputs, the warm run's equal to the cold run's")
        k = sm.kernels[kern]
        k["launches_2p"] = [c["launches"][kern] for c in cold]
        k["ms_2p"] = [1e3 * rec["warm"]["run_s"]
                      / max(rec["warm"]["launches"][kern], 1) for rec in per]

    # --- 34. checkpoints across processes ------------------------------------
    h31 = np.asarray(getattr(sm, "mesh_flagship_hist", []))
    want_it = getattr(sm, "flagship_iters", 18)
    path = o0["ck_path"]
    A = laplacian_2d(512)
    one = RASolver(decompose(A, generate_rhs(A.n), Settings(
        partition=Partition.regular, precond=Precond.fsai, **FLAGSHIP),
        MESH_RANKS))
    r1 = one.run(resume_state=one.load_checkpoint(path))
    del one
    for what, it, hist, rel in (
            ("on 2 processes", o0["ck_resumed"]["iters"],
             o0["ck_resumed"]["hist"], o0["ck_resumed"]["rel"]),
            ("in one process", r1.iters, r1.global_resnorm_history,
             r1.relative_residual_norm)):
        h = np.asarray(hist)
        gap = (float(np.abs(h / h31 - 1).max())
               if len(h) == len(h31) else float("inf"))
        sm.check(o0["ck_stop_iters"] == FLAGSHIP_STOP and it == want_it
                 and rel <= 1e-8 and gap <= MESH_HISTORY_RTOL,
                 f"phase 34: the flagship stopped at {o0['ck_stop_iters']} "
                 f"iterations on 2 processes and resumed {what}: {it} "
                 f"iterations (phase 20: {want_it}), true relative residual "
                 f"{rel:.3e}, history within {gap:.3e} <= "
                 f"{MESH_HISTORY_RTOL:g} of phase 31's 2-process run")
    cf = o0["ck_free"]
    sm.check(all(o["ck_free"]["same_x"] for o in outs)
             and cf["done_at"] == cf["straight_done_at"],
             f"phase 34: a free-running 1-D checkpoint across processes "
             f"resumes to the straight run (done_at {cf['done_at']})")
    os.environ.pop("SCHWARZ_TPU_COARSE_CACHE")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import schwarz_tpu_torch  # noqa: F401
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
    # every partition below goes through the native setup library: the
    # card's host must never take the Python loops unseen
    from schwarz_tpu_torch import native

    if not native.available():
        print(f"chip_smoke: {native.reason}", file=sys.stderr)
        return 1
    return _phases(sm, torch)


def _phases(sm, torch) -> int:
    """Phases 3-35."""
    import numpy as np

    from schwarz_tpu_torch import (CommSettings, HaloStrategy, Precond,
                                   RASolver, Settings)
    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d

    # --- the slice's setup ---------------------------------------------------
    t0 = time.perf_counter()
    A = laplacian_2d(1024)
    b = generate_rhs(A.n, random=False)
    settings = Settings(precond=Precond.jacobi, **SLICE)
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
    res, launches = counted(solver.run)
    n_it = len(res.global_resnorm_history)
    print(f"slice: {n_it} outer iterations, converged={res.converged}, "
          f"wall {res.solve_time_s:.3f} s "
          f"({1e3 * res.solve_time_s / max(n_it, 1):.2f} ms/iteration), "
          f"true relative residual (float64, host) "
          f"{res.relative_residual_norm:.6e}", flush=True)
    print("global residual history: " + " ".join(
        f"{v:.6e}" for v in res.global_resnorm_history), flush=True)
    print(f"launches in the slice: {launches}", flush=True)
    from schwarz_tpu_torch.ops.fused_cg import fused_cg_solve

    print(f"K3 on the slice: {fused_cg_solve.cluster} blocks per subdomain, "
          f"{fused_cg_solve.variant} memory", flush=True)
    for k in ("dia_spmv", "halo_runs", "fused_cg"):
        sm.check(launches[k] > 0,
                 f"{k} launched {launches[k]} times on the main path")
    sm.check(launches["halo_runs"] == n_it,
             f"K2 launched once per exchange ({launches['halo_runs']} for "
             f"{n_it} outer iterations)")
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
    # one exchange of the slice, counted with the profiler, on all_gather
    # with and without a bfloat16 halo and on rdma (the solver of phase
    # 18), each having run once before the window (the profiler missed
    # kernels of a library first launched after its first window)
    solver_rd = RASolver(dataclasses.replace(dec, settings=settings.replace(
        comm=CommSettings(strategy=HaloStrategy.rdma, enable_put=True,
                          enable_get=False))), num_ranks=16)
    ms_it = 1e3 * warm.solve_time_s / max(n_it, 1)
    solver_h = RASolver(dataclasses.replace(
        dec, settings=settings.replace(halo_dtype="bfloat16")))
    exchange_costs(sm, [(solver_rd, "rdma (K4, then K2)", 2, None),
                        (solver, "all_gather", 1, ms_it),
                        (solver_h, "all_gather, bfloat16 halos", 1, ms_it)])
    del solver_h

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
    res2, launches2 = counted(RASolver(dec2).run)
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

    # --- 7-10. the free-running slice and the diagnostics ---------------------
    free_running_phases(sm)

    # --- 11-13. the 2-D block-grid tier ---------------------------------------
    block_grid_phases(sm)

    # --- 14-16. the general-graph tier ----------------------------------------
    general_graph_phases(sm)

    # --- 17-19. the neighbour / one-sided exchange and the protocols ----------
    neighbor_exchange_phases(sm, dec, solver_rd, hist,
                             1e3 * warm.solve_time_s / max(n_it, 1))

    # --- 20-23. the flagship recipe, O-RAS through K3, two-level refinement --
    flagship_phases(sm)

    # --- 24-26. the campaign configuration, direct locals, checkpoints -------
    campaign_phases(sm)
    direct_phases(sm)

    # --- 27. the native setup against the Python loops -----------------------
    native_setup_phase(sm)

    # --- 28-30. the command line, the instrumented run, the CLI's branches ---
    torch.cuda.empty_cache()
    for what, phase in (
            ("28 (the CLI on the flagship)", lambda: cli_flagship_phase(sm)),
            ("29 (instrumented on the card)",
             lambda: instrumented_phase(sm, dec, settings)),
            ("30 (the CLI's other branches)", lambda: cli_branch_phase(sm))):
        t0 = time.perf_counter()
        phase()
        print(f"phase {what} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    # --- 31. the solve across processes, the first example ------------------
    t0 = time.perf_counter()
    try:
        mesh_phases(sm)
    except RuntimeError as e:
        sm.check(False, f"phase 31: {e}")
    print(f"phase 31 (across processes) took {time.perf_counter() - t0:.1f} "
          f"s", flush=True)

    # --- 32-34. rdma, free-running and checkpoints across processes ---------
    t0 = time.perf_counter()
    try:
        mesh_async_phases(sm)
    except RuntimeError as e:
        sm.check(False, f"phases 32-34: {e}")
    print(f"phases 32-34 (rdma, free-running, checkpoints across processes) "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 35. the kernels line and the last line ------------------------------
    meta_k = {
        "dia_spmv_float32": ("csrc/dia_spmv.cu",
                             "schwarz_tpu/ops/pallas_kernels.py:110"),
        "dia_spmv_float64": ("csrc/dia_spmv.cu",
                             "schwarz_tpu/ops/pallas_kernels.py:110"),
        "halo_runs": ("csrc/halo_runs.cu", "schwarz_tpu/ops/halo_pallas.py:142"),
        "fused_cg": ("csrc/fused_cg.cu", "schwarz_tpu/ops/fused_cg.py:84"),
        "async_ras": ("csrc/async_ras.cu",
                      "schwarz_tpu/ops/async_ras.py:394"),
        "async_ras_2d": ("csrc/async_ras_2d.cu",
                         "schwarz_tpu/ops/async_ras_2d.py:232"),
        "async_ras_general": ("csrc/async_ras_general.cu",
                              "schwarz_tpu/ops/async_ras_general.py:360"),
        "rdma_shift": ("csrc/rdma_shift.cu",
                       "schwarz_tpu/parallel/neighbor_exchange.py:167"),
        "smoke_x2": ("csrc/diagnostics.cu", "scripts/tpu_diagnostics.py:53"),
        "flag_order_probe": ("csrc/diagnostics.cu",
                             "scripts/tpu_diagnostics.py:214"),
        **{f"dia_spmv_flagship_{k}": ("csrc/dia_spmv.cu",
                                      "schwarz_tpu/ops/pallas_kernels.py:110")
           for k in ("A_f64", "A_f32", "chain")},
        "fused_cg_oras": ("csrc/fused_cg.cu", "schwarz_tpu/ops/fused_cg.py:84"),
        **{f"dia_spmv_{k}": ("csrc/dia_spmv.cu",
                             "schwarz_tpu/ops/pallas_kernels.py:110")
           for k in ("campaign", "direct")},
        **{f"halo_runs_{k}": ("csrc/halo_runs.cu",
                              "schwarz_tpu/ops/halo_pallas.py:142")
           for k in ("campaign", "direct")},
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
            "library_ms": k["library_ms"],
            **{e: k[e] for e in ("cluster", "variant", "threads",
                                 "ms_one_block", "ms_global",
                                 "rounds_per_launch", "tile",
                                 "two_launches_ms", "library_two_ms",
                                 "launches_2p", "ms_2p", "wait_ms_2p")
               if e in k}})
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
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2:]))
    sys.exit(main())
