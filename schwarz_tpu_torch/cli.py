"""Command-line entry point of the port, ``python -m schwarz_tpu_torch``: the
counterpart of ``schwarz_tpu/cli.py`` and of the reference's ``bench_ras``
(benchmarking/bench_ras.cpp + the ~45 gflags of bench_base.hpp:50-144).

Same option strings, defaults and choices as the JAX package's CLI, the
same status lines on stderr, one JSON line on stdout, the same CSV files and
exit codes.  Three differences, by design:

  - ``--executor`` takes ``auto | cuda | cpu``; ``auto`` and ``cuda`` run on
    the CUDA device and raise :class:`~schwarz_tpu_torch.utils.backend.
    ExecutorError` without one (no fall back to the CPU);
  - without ``--num_subdomains`` there is one subdomain (the port's
    ``solve()`` default), and the ``config:`` line prints the port's device
    count;
  - ``--profile_dir DIR`` writes a ``torch.profiler`` Chrome trace of the
    solve into DIR, with the port's layer spans (``schwarz.*``) on it.

Run e.g.::

    python -m schwarz_tpu_torch --set_1d_laplacian_size 64 \
        --num_subdomains 4 --overlap 3 --set_tol 1e-6

"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="schwarz_tpu_torch",
        description="restricted additive Schwarz solver, PyTorch / CUDA",
    )
    # problem (bench_base.hpp:57-66)
    p.add_argument("--matrix_filename", default="null",
                   help="MatrixMarket file; 'null' uses the generated problem")
    p.add_argument("--explicit_laplacian", action="store_true",
                   help="generate the in-house 2D Laplacian")
    p.add_argument("--set_1d_laplacian_size", type=int, default=16,
                   help="grid side n; global size n^2")
    p.add_argument("--problem", default="laplacian",
                   choices=["laplacian", "laplacian3d", "anisotropic",
                            "advection", "helmholtz", "fem",
                            "fem_advection", "fem_elasticity"],
                   help="generated problem family (replaces the deal.II "
                        "examples; 'fem' = real P1 assembly with adaptive "
                        "local refinement, the dealii_ex_6 role)")
    p.add_argument("--fem_refine_levels", type=int, default=2,
                   help="local-refinement rounds for --problem fem")
    p.add_argument("--fem_eps", type=float, default=1.0,
                   help="anisotropy ratio for --problem fem (ani3/ani4 role)")
    p.add_argument("--enable_random_rhs", action="store_true")
    # decomposition (bench_base.hpp:91-96)
    p.add_argument("--num_subdomains", type=int, default=None,
                   help="default: one per device")
    p.add_argument("--overlap", type=int, default=2)
    p.add_argument("--partition", default="regular",
                   choices=["regular", "regular2d", "metis"])
    p.add_argument("--metis_objtype", default="edgecut")
    # solver (bench_base.hpp:54-56, 67-90)
    p.add_argument("--set_tol", type=float, default=1e-6)
    p.add_argument("--local_tol", type=float, default=1e-12)
    p.add_argument("--num_iters", type=int, default=100)
    p.add_argument("--local_max_iters", type=int, default=-1)
    p.add_argument("--local_solver", default="iterative-ginkgo",
                   help="cg | gmres | cholesky | lu "
                        "(aliases: iterative-ginkgo->cg, direct-cholmod->cholesky,"
                        " direct-umfpack/direct-ginkgo->lu)")
    p.add_argument("--non_symmetric_matrix", action="store_true")
    p.add_argument("--direct_apply", default="trisolve",
                   choices=["trisolve", "inverse", "blocked"],
                   help="direct local-solve application: trisolve = batched "
                        "substitution; inverse = one batched matmul per "
                        "solve; blocked = panel substitution with "
                        "pre-inverted diagonal blocks (inverse/blocked: "
                        "cholesky only)")
    p.add_argument("--restart_iter", type=int, default=30)
    p.add_argument("--reset_local_crit_iter", type=int, default=-1)
    p.add_argument("--use_precond", action="store_true")
    p.add_argument("--two_level", action="store_true",
                   help="multiplicative Nicolaides coarse correction "
                        "(beyond-reference scalability feature)")
    p.add_argument("--coarse_aggregates", type=int, default=1,
                   help="coarse DOFs per subdomain in the two-level "
                        "coarse space (1 = Nicolaides; aggregates mode "
                        "requires a divisor of the padded interior width)")
    p.add_argument("--coarse_space", default="aggregates",
                   choices=["aggregates", "spectral"],
                   help="two-level coarse DOF type: contiguous index "
                        "aggregates, or per-subdomain lowest eigenvectors "
                        "(GenEO-style; stronger per DOF, algebraic)")
    p.add_argument("--coarse_solver", default="dense",
                   choices=["dense", "cg"],
                   help="coarse-system solve: row-sharded replicated "
                        "inverse (dense), or distributed CG on the "
                        "row-sharded Galerkin matrix (cg — nothing (qS)^2 "
                        "inverted/replicated; scales with subdomain count)")
    p.add_argument("--accelerator", default="none", choices=["none", "fgmres"],
                   help="fgmres: Krylov-accelerate with RAS as preconditioner "
                        "(several-fold fewer outer iterations)")
    p.add_argument("--precond", default="block-jacobi",
                   choices=["jacobi", "block-jacobi", "fsai", "ilu"],
                   help="fsai = FSAI(0) factorized sparse approximate "
                        "inverse (the ISAI role, applied as two SpMVs); "
                        "ilu = ILU(0) on A's pattern (the ParILU role), "
                        "applied via --ilu_sweeps truncated-Neumann "
                        "Jacobi sweeps per factor — SpMVs, no triangular "
                        "substitution")
    p.add_argument("--ilu_sweeps", type=int, default=3,
                   help="Jacobi sweeps per triangular factor in the "
                        "ILU(0) apply")
    def float_or_auto(v):
        return v if v == "auto" else float(v)

    p.add_argument("--oras_weight", type=float_or_auto, default=0.0,
                   help="O-RAS Robin transmission coefficient c: local solves "
                        "see diag += c*sum|dropped couplings| on boundary "
                        "rows (0 = classical Dirichlet RAS, -1 = Neumann; "
                        "'auto' = -0.8 one-level / -0.6 with two_level, "
                        "typically 2-4x fewer outer iterations)")
    p.add_argument("--dia_max_diags", type=int, default=16,
                   help="max dense diagonals in the DIA split (more = smaller "
                        "scalar-gather remainder)")
    p.add_argument("--inner_operator", default="exact",
                   choices=["exact", "dia_only"],
                   help="dia_only drops the ELL remainder from the INNER "
                        "solve operator (convergence checks keep exact A)")
    p.add_argument("--fused_local_cg", action="store_true",
                   help="run each local CG solve as ONE CUDA kernel launch "
                        "(K3; needs --local_solver cg, a pure-DIA operator, "
                        "f32 local compute, precond none, jacobi or fsai; "
                        "implies row padding to 128); on the card a run "
                        "that meets these takes K3 without the flag")
    p.add_argument("--precond_max_block_size", type=int, default=16)
    # reference-named aliases (bench_base.hpp:119-140) for the knobs above —
    # scripted reference campaigns port without edits
    p.add_argument("--local_precond", default="null",
                   choices=["null", "jacobi", "block-jacobi", "isai", "fsai",
                            "ilu", "parilu"],
                   help="reference alias for --use_precond/--precond: null="
                        "none; isai maps to fsai (the SPD-safe factorized "
                        "variant of the same approximate-inverse role); "
                        "ilu/parilu map to ILU(0) with Jacobi-sweep "
                        "triangular applies (no substitution)")
    p.add_argument("--local_factorization", default=None,
                   choices=["cholmod", "umfpack"],
                   help="reference alias for the direct-solver flavor: "
                        "cholmod -> batched dense Cholesky, umfpack -> "
                        "batched dense LU (implies a direct local solver)")
    p.add_argument("--local_reordering", default="none",
                   choices=["none", "rcm_reordering", "metis_reordering"],
                   help="reference knob; dense factorization has no "
                        "fill-in, so reorderings are moot — any non-default "
                        "value prints a notice and is otherwise inert "
                        "BY DESIGN (cf. COVERAGE.md C13)")
    p.add_argument("--factor_ordering_natural", action="store_true",
                   help="reference knob; moot for dense factors (see "
                        "--local_reordering)")
    p.add_argument("--enable_debug_write", action="store_true",
                   help="reference alias: debug dumps (Settings."
                        "write_debug_out)")
    p.add_argument("--num_threads", type=int, default=1,
                   help="reference knob (threads bound per MPI process for "
                        "MPI_THREAD_MULTIPLE); here PyTorch owns all host "
                        "threading — values > 1 print a notice")
    p.add_argument("--stage_through_host", action="store_true",
                   help="reference knob (host-staged halo copies for "
                        "non-CUDA-aware MPI); raises NotImplementedFeature "
                        "(device buffers ARE the transport; no host staging "
                        "exists to emulate)")
    # communication (bench_base.hpp:97-130)
    p.add_argument("--enable_onesided", action="store_true")
    p.add_argument("--enable_twosided", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="reference flag: --no-enable_twosided selects the "
                        "one-sided paradigm (same as --enable_onesided)")
    p.add_argument("--free_running", action="store_true",
                   help="TRUE asynchronous mode: a multi-iteration CUDA "
                        "kernel (K5, K6 or K7) in which ranks iterate at "
                        "independent rates with bounded-staleness one-sided "
                        "halos and in-band gossip detection "
                        "(restricted_schwarz.cpp:714-852)")
    p.add_argument("--async_chunk_rounds", type=int, default=16,
                   help="free-running iterations per kernel launch")
    p.add_argument("--fresh_read", action="store_true",
                   help="free-running mode: consume the freshest fully-"
                        "arrived message (sequence-word peek) instead of "
                        "the guaranteed staleness-old slot; shrinks "
                        "effective staleness to the arrival lag when "
                        "staleness > 1")
    p.add_argument("--async_ninner", type=int, default=16,
                   help="inner CG iterations per free-running outer iteration")
    p.add_argument("--enable_overlap", "--enable_comm_overlap",
                   action="store_true",
                   help="overlap communication with computation")
    p.add_argument("--enable_overlap_split", action="store_true",
                   help="exact comm/compute overlap via the interior/"
                        "boundary split of the linear local solve (fixed "
                        "point unchanged; needs --local_solver cholesky "
                        "--direct_apply inverse)")
    p.add_argument("--enable_put_all_local_residual_norms", action="store_true")
    p.add_argument("--enable_comm_overlap_staleness", type=int, default=1,
                   help="halo staleness (iterations) in async emulation")
    p.add_argument("--use_mixed_precision", action="store_true",
                   help="float32 halo buffers with float64 compute")
    p.add_argument("--local_compute_dtype", default=None,
                   choices=["float32", "float64"],
                   help="run local solves in this dtype under the outer dtype "
                        "(iterative refinement: f64 accuracy at f32 speed)")
    p.add_argument("--flush_type", default="flush-all",
                   choices=["flush-all", "flush-local"],
                   help="one-sided completion discipline for one-by-one "
                        "element transfers (comm_helpers.hpp:128-149)")
    p.add_argument("--lock_type", default="lock-all",
                   help="only 'lock-all' (passive target) exists here; "
                        "other values fail loudly")
    p.add_argument("--remote_comm_type", default="get", choices=["put", "get"],
                   help="one-sided transfer direction: put = sender push, "
                        "get = receiver-initiated request+reply")
    p.add_argument("--enable_one_by_one", action="store_true",
                   help="one remote write per element instead of per "
                        "packed buffer (transfer_one_by_one, "
                        "comm_helpers.hpp:58-89)")
    p.add_argument("--comm_strategy", default="all_gather",
                   choices=["all_gather", "neighbor", "rdma"])
    # convergence (bench_base.hpp:131-140)
    p.add_argument("--enable_global_check", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="trust-local allgather detection; "
                        "--no-enable_global_check selects the two-sided "
                        "allreduce convergence branch (solve.cpp:949-953)")
    p.add_argument("--global_convergence_type", default="centralized-tree",
                   choices=["allgather", "allreduce", "tree",
                            "centralized-tree", "decentralized"],
                   help="detection protocol (effective with "
                        "--enable_onesided)")
    p.add_argument("--enable_decentralized_accumulate", action="store_true")
    p.add_argument("--enable_global_check_iter_offset", action="store_true")
    p.add_argument("--local_convergence_crit", default="solution-based",
                   choices=["solution-based", "residual-based"])
    # precision / execution
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    p.add_argument("--executor", default="auto",
                   help="auto | cuda | cpu; auto means cuda and never falls "
                        "back to the CPU (reference: omp/cuda/reference)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="accepted for the JAX CLI's flag surface; the "
                        "port runs every subdomain on one device")
    # output (bench_base.hpp:141-144)
    p.add_argument("--enable_logging", action="store_true")
    p.add_argument("--shifted_iter", action="store_true",
                   help="staggered rounds (settings.hpp:212) — dead in the "
                        "reference v1; raises NotImplementedFeature")
    p.add_argument("--write_iters_and_residuals", action="store_true")
    p.add_argument("--write_comm_data", action="store_true")
    p.add_argument("--print_matrices", action="store_true",
                   help="dump the (permuted) global matrix to matrix.csv "
                        "(utils.cpp:93-108)")
    p.add_argument("--write_perm_data", action="store_true",
                   help="dump the subdomain permutation to perm.csv")
    p.add_argument("--timings_file", default="null")
    p.add_argument("--print_config", action="store_true", default=True)
    p.add_argument("--debug_print", "--debug", action="store_true",
                   help="debug prints + expensive validation checks (the reference's --debug role)")
    p.add_argument("--instrument", action="store_true",
                   help="per-stage timing (unfused loop; slower)")
    p.add_argument("--profile_dir", default=None,
                   help="capture a torch.profiler Chrome trace of the solve "
                        "into DIR (CPU and CUDA activities), with the "
                        "port's layer spans (schwarz.*) on it; replaces "
                        "the reference's easy_profiler hookup, "
                        "CMakeLists.txt:236-239")
    p.add_argument("--checkpoint", default=None,
                   help="write the final solver state to this .npz")
    p.add_argument("--resume", default=None,
                   help="resume from a solver-state .npz")
    p.add_argument("--chunk_iters", type=int, default=None,
                   help="cap outer iterations per device execution")
    p.add_argument("--baseline_direct", action="store_true",
                   help="also solve with a host sparse direct solver and "
                        "report its time/residual (the reference's "
                        "--dealii_orig comparison baseline, dealii_ex_6.cpp:49)")
    return p


def settings_from_args(args):
    from schwarz_tpu_torch.config import (
        CommSettings,
        ConvergenceSettings,
        GlobalConvergence,
        HaloStrategy,
        LocalCriterion,
        LocalSolver,
        Partition,
        Precond,
        Settings,
    )

    solver_alias = {
        "cg": LocalSolver.iterative_cg,
        "iterative-ginkgo": LocalSolver.iterative_cg,
        "gmres": LocalSolver.iterative_gmres,
        "cholesky": LocalSolver.direct_cholesky,
        "direct-cholmod": LocalSolver.direct_cholesky,
        "lu": LocalSolver.direct_lu,
        "direct-umfpack": LocalSolver.direct_lu,
        "direct-ginkgo": LocalSolver.direct_lu,
    }
    if args.local_solver not in solver_alias:
        sys.exit(
            f"error: unknown --local_solver '{args.local_solver}' "
            f"(choose from {', '.join(sorted(solver_alias))})"
        )
    local_solver = solver_alias[args.local_solver]
    if args.local_factorization is not None:
        # reference alias: the factorization choice IS the direct flavor
        # here (batched dense Cholesky / dense LU)
        local_solver = (LocalSolver.direct_cholesky
                        if args.local_factorization == "cholmod"
                        else LocalSolver.direct_lu)
    if args.local_reordering != "none" or args.factor_ordering_natural:
        print(
            "note: local reordering flags are moot here — local factors are "
            "batched DENSE Cholesky/LU (no fill-in, no ordering "
            "dimension); the flags are accepted for reference-script parity "
            "only (COVERAGE.md C13)",
            file=sys.stderr,
        )
    if args.local_precond != "null":
        if args.local_precond == "isai":
            print("note: isai maps to FSAI — the factorized (SPD-safe) "
                  "variant of the same approximate-inverse role",
                  file=sys.stderr)
        if args.local_precond == "parilu":
            print("note: parilu maps to ILU(0) with truncated-Neumann "
                  "(Jacobi-sweep) triangular applies — the ParILU role "
                  "without substitution", file=sys.stderr)
        args.use_precond = True
        args.precond = {"jacobi": "jacobi", "block-jacobi": "block-jacobi",
                        "isai": "fsai", "fsai": "fsai",
                        "ilu": "ilu", "parilu": "ilu"}[args.local_precond]
    if not args.enable_twosided:
        args.enable_onesided = True
    if args.num_threads > 1:
        print(
            "note: --num_threads is the reference's MPI thread-binding "
            "knob; PyTorch owns all host threading here — the value is "
            "accepted for script parity and has no effect",
            file=sys.stderr,
        )
    if args.problem == "fem_advection":
        # the SUPG advection operator is non-symmetric by construction
        args.non_symmetric_matrix = True
    if args.non_symmetric_matrix and local_solver == LocalSolver.iterative_cg:
        local_solver = LocalSolver.iterative_gmres  # solve.cpp:746-752 dispatch

    conv_alias = {
        "allgather": GlobalConvergence.allgather,
        "allreduce": GlobalConvergence.allreduce,
        "tree": GlobalConvergence.tree,
        "centralized-tree": GlobalConvergence.tree,
        "decentralized": GlobalConvergence.decentralized,
    }
    if args.enable_onesided:
        method = conv_alias[args.global_convergence_type]
    else:
        method = (
            GlobalConvergence.allgather
            if args.enable_global_check
            else GlobalConvergence.allreduce
        )

    return Settings(
        partition=Partition[args.partition],
        overlap=args.overlap,
        local_solver=local_solver,
        non_symmetric_matrix=args.non_symmetric_matrix,
        restart_iter=args.restart_iter,
        reset_local_crit_iter=args.reset_local_crit_iter,
        direct_apply=args.direct_apply,
        precond=(
            Precond.none if not args.use_precond else
            {"jacobi": Precond.jacobi,
             "block-jacobi": Precond.block_jacobi,
             "fsai": Precond.fsai,
             "ilu": Precond.ilu}[args.precond]
        ),
        block_jacobi_block_size=args.precond_max_block_size,
        ilu_sweeps=args.ilu_sweeps,
        max_iters=args.num_iters,
        two_level=args.two_level,
        coarse_aggregates=args.coarse_aggregates,
        coarse_space=args.coarse_space,
        coarse_solver=args.coarse_solver,
        accelerator=args.accelerator,
        fused_local_cg=args.fused_local_cg,
        oras_weight=args.oras_weight,
        dia_max_diags=args.dia_max_diags,
        inner_operator=args.inner_operator,
        # the fused kernel needs 128-aligned rows and the DIA operator
        **({"row_pad_multiple": 128, "spmv_format": "dia"}
           if args.fused_local_cg else {}),
        tolerance=args.set_tol,
        local_tolerance=args.local_tol,
        local_max_iters=args.local_max_iters,
        write_debug_out=args.enable_debug_write,
        comm=CommSettings(
            onesided=args.enable_onesided,
            overlap_comm=args.enable_overlap,
            overlap_split=args.enable_overlap_split,
            strategy=HaloStrategy(args.comm_strategy),
            staleness=(
                args.enable_comm_overlap_staleness if args.enable_onesided else 0
            ),
            enable_put=args.remote_comm_type == "put",
            enable_get=args.remote_comm_type == "get",
            enable_one_by_one=args.enable_one_by_one,
            flush_type=args.flush_type,
            lock_type=args.lock_type,
            fresh_read=args.fresh_read,
            stage_through_host=args.stage_through_host,
        ),
        convergence=ConvergenceSettings(
            method=method,
            criterion=(
                LocalCriterion.residual_based
                if args.local_convergence_crit == "residual-based"
                else LocalCriterion.solution_based
            ),
            put_all_local_residual_norms=args.enable_put_all_local_residual_norms,
            enable_accumulate=args.enable_decentralized_accumulate,
            enable_global_check_iter_offset=args.enable_global_check_iter_offset,
        ),
        dtype=args.dtype,
        halo_dtype="float32" if args.use_mixed_precision else None,
        local_compute_dtype=args.local_compute_dtype,
        metis_objtype=args.metis_objtype,
        debug_print=args.debug_print,
        write_iters_and_residuals=args.write_iters_and_residuals,
        enable_logging=args.enable_logging,
        shifted_iter=args.shifted_iter,
    )


def _problem(args):
    """``(mat, rhs, cell_weights)`` of the run: a MatrixMarket file, one of
    the three FEM generators (with their own rhs and cell weights), or a
    generated operator with :func:`generate_rhs`."""
    from schwarz_tpu_torch.models import (
        advection_diffusion_2d,
        anisotropic_diffusion_2d,
        fem_p1_advection,
        fem_p1_elasticity,
        fem_p1_poisson,
        generate_rhs,
        helmholtz_2d,
        laplacian_2d,
        laplacian_3d,
        read_mtx,
    )

    if args.matrix_filename != "null":
        try:
            mat = read_mtx(args.matrix_filename)
        except FileNotFoundError:
            # cf. the reference's message, initialization.cpp:206-209
            sys.exit(
                f'Could not find the file "{args.matrix_filename}", '
                "which is required for this run."
            )
        print(f"Matrix from file {args.matrix_filename}", file=sys.stderr)
        return mat, generate_rhs(mat.n, random=args.enable_random_rhs), None
    if args.problem == "fem":
        mat, rhs, _coords, cell_weights = fem_p1_poisson(
            args.set_1d_laplacian_size,
            refine_levels=args.fem_refine_levels,
            eps=args.fem_eps, theta=0.5 if args.fem_eps != 1.0 else 0.0,
        )
        print(
            f"P1 FEM matrix (assembled, {args.fem_refine_levels} refinement "
            f"levels), n={mat.n}", file=sys.stderr,
        )
        return mat, rhs, cell_weights
    if args.problem == "fem_advection":
        mat, rhs, _coords, cell_weights = fem_p1_advection(
            args.set_1d_laplacian_size,
            refine_cycles=args.fem_refine_levels,
        )
        print(
            f"P1 SUPG advection matrix (dealii_ex_9 role, "
            f"{args.fem_refine_levels} gradient-estimator refinement "
            f"cycles), n={mat.n}", file=sys.stderr,
        )
        return mat, rhs, cell_weights
    if args.problem == "fem_elasticity":
        mat, rhs, _coords, cell_weights = fem_p1_elasticity(
            args.set_1d_laplacian_size,
        )
        print(
            f"vector-P1 elasticity matrix (dealii_ex_17 role), n={mat.n}",
            file=sys.stderr,
        )
        return mat, rhs, cell_weights
    gen = {
        "laplacian": laplacian_2d,
        "laplacian3d": laplacian_3d,
        "anisotropic": anisotropic_diffusion_2d,
        "advection": advection_diffusion_2d,
        "helmholtz": helmholtz_2d,
    }[args.problem]
    mat = gen(args.set_1d_laplacian_size)
    print(f"{args.problem} 2D matrix (generated in house), n={mat.n}",
          file=sys.stderr)
    return mat, generate_rhs(mat.n, random=args.enable_random_rhs), None


def _run_free_running(args, mat, rhs, S, settings, device) -> int:
    """The free-running branch: the tier the dispatch chain picks, plain
    or with iterative-refinement restarts, and its checkpoints."""
    from schwarz_tpu_torch.exceptions import SchwarzError
    from schwarz_tpu_torch.ras import make_free_running_solver

    try:
        fr, refine = make_free_running_solver(
            mat, rhs, S, settings,
            ninner=args.async_ninner,
            chunk_rounds=args.async_chunk_rounds,
            fresh_read=args.fresh_read,
            device=device,
        )
    except (ValueError, SchwarzError) as e:
        sys.exit(f"error: {e}")
    print(f" free-running kernel: {type(fr).__name__}", file=sys.stderr)
    if refine:
        fr_resume = (
            np.load(args.resume if args.resume.endswith(".npz")
                    else args.resume + ".npz")["ir_x"]
            if args.resume else None
        )
        x, info = fr.run_refined(
            tol=settings.tolerance,
            max_rounds=settings.max_iters,
            resume_state=fr_resume,
            checkpoint_path=args.checkpoint,
            coarse_q=(max(1, settings.coarse_aggregates)
                      if settings.two_level else 0),
        )
        info["done_at"] = np.asarray(info["done_at"])
        print(
            f" free-running async (refined): restarts="
            f"{info['restarts']}", file=sys.stderr,
        )
    else:
        fr_resume = fr.load_checkpoint(args.resume) if args.resume else None
        x, info = fr.run(
            max_rounds=settings.max_iters,
            resume_state=fr_resume,
            checkpoint_path=args.checkpoint,
        )
    print(
        f" free-running async: converged={info['converged']} "
        f"done_at={info['done_at'].tolist()} rounds={info['rounds']}\n"
        f" relative residual norm of solution "
        f"{info['relative_residual_norm']:.6e}\n"
        f" Time taken for solve {info['time_s']:.6f}",
        file=sys.stderr,
    )
    print(json.dumps({
        "converged": info["converged"],
        "iters": int(max(info["done_at"].max(), 0)),
        "done_at": info["done_at"].tolist(),
        "relative_residual_norm": info["relative_residual_norm"],
        "solve_time_s": info["time_s"],
    }))
    return 0 if info["converged"] else 1


def _profiled(profile_dir, device):
    """A ``torch.profiler`` window that writes ``trace.json`` (Chrome
    format) into ``profile_dir`` when it closes, with the program's spans
    recorded inside it; a no-op without one."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    from schwarz_tpu_torch.utils import timing

    @contextlib.contextmanager
    def window():
        activities = [ProfilerActivity.CPU]
        if device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            prev = timing.recording(True)
            try:
                yield
            finally:
                timing.recording(prev)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    return window()


def main(argv=None):
    args = build_parser().parse_args(argv)

    # executor selection (reference: schwarz_base.cpp:86-123): the card, or
    # the CPU only when asked for by name
    from schwarz_tpu_torch.utils.backend import ensure_backend

    device = ensure_backend(args.executor)

    import torch

    from schwarz_tpu_torch.core.decompose import decompose
    from schwarz_tpu_torch.exceptions import SchwarzError
    from schwarz_tpu_torch.ras import RASolver
    from schwarz_tpu_torch.utils import (
        write_comm_data,
        write_iters_and_residuals,
        write_timings,
    )

    settings = settings_from_args(args)
    mat, rhs, cell_weights = _problem(args)

    S = args.num_subdomains or 1
    if args.print_config:
        n_dev = torch.cuda.device_count() if device == "cuda" else 1
        print(
            f"config: S={S} overlap={settings.overlap} "
            f"solver={settings.local_solver.value} tol={settings.tolerance} "
            f"partition={settings.partition.value} dtype={settings.dtype} "
            f"conv={settings.convergence.method.value} "
            f"devices={n_dev}",
            file=sys.stderr,
        )

    if args.free_running:
        return _run_free_running(args, mat, rhs, S, settings, device)

    dec = decompose(mat, rhs, settings, S, cell_weights=cell_weights)
    if args.print_matrices:
        from schwarz_tpu_torch.utils.validation import dump_csr_csv

        dump_csr_csv(dec.global_matrix, "matrix.csv")
    if args.write_perm_data:
        owners = np.searchsorted(dec.first_row, np.arange(mat.n), "right") - 1
        with open("perm.csv", "w") as f:
            f.write("new,old,subdomain\n")
            for i in range(mat.n):
                f.write(f"{i},{dec.perm[i]},{owners[i]}\n")

    try:
        solver = RASolver(dec, device=device)
    except (ValueError, SchwarzError) as e:
        # configuration validation (e.g. fused_local_cg gating): exit with the
        # message, not a traceback
        sys.exit(f"error: {e}")
    resume_state = (
        solver.load_checkpoint(args.resume)
        if args.resume and args.accelerator != "fgmres" else None
    )
    with _profiled(args.profile_dir, device):
        if args.accelerator == "fgmres":
            accel_resume = (
                solver.load_accel_checkpoint(args.resume)
                if args.resume else None
            )
            result = solver.run_accelerated(
                resume_state=accel_resume,
                checkpoint_path=args.checkpoint,
                chunk_iters=args.chunk_iters,
                instrument=args.instrument,
            )
        elif args.instrument:
            result = solver.run_instrumented()
        else:
            result = solver.run(
                resume_state=resume_state, checkpoint_path=args.checkpoint,
                chunk_iters=args.chunk_iters,
            )

    if args.baseline_direct:
        import scipy.sparse.linalg as spla

        t0 = time.perf_counter()
        x_direct = spla.spsolve(mat.to_scipy().tocsc(), rhs)
        t_direct = time.perf_counter() - t0
        res_d = np.linalg.norm(rhs - mat.to_scipy() @ x_direct) / max(
            np.linalg.norm(rhs), 1e-300
        )
        err = float(
            np.linalg.norm(result.solution - x_direct)
            / max(np.linalg.norm(x_direct), 1e-300)
        )
        print(
            f" direct baseline: time {t_direct:.6f}s rel residual {res_d:.3e} "
            f"| RAS-vs-direct solution error {err:.3e}",
            file=sys.stderr,
        )

    status = "converged" if result.converged else (
        "DIVERGED" if result.diverged else "did not converge")
    print(
        f" {status} in {result.iters} iterations\n"
        f" residual norm {result.residual_norm:.6e}\n"
        f" relative residual norm of solution "
        f"{result.relative_residual_norm:.6e}\n"
        f" Time taken for solve {result.solve_time_s:.6f}",
        file=sys.stderr,
    )
    if not result.converged and not result.diverged:
        # actionable hints instead of a bare failure: one-level RAS with
        # the reference defaults stalls on all but tiny problems (its
        # iteration count grows with 1/H — the known one-level limit)
        hints = []
        if not settings.two_level:
            hints.append("--two_level (coarse space removes the "
                         "subdomain-count dependence)")
        if settings.oras_weight == 0.0:
            hints.append("--oras_weight -0.8 (optimized Robin "
                         "transmission)")
        if settings.overlap <= 2:
            hints.append(f"a larger --overlap (currently "
                         f"{settings.overlap})")
        if args.num_iters <= 100:
            hints.append(f"more --num_iters (currently {args.num_iters})")
        if hints:
            print(" hint: try " + "; ".join(hints), file=sys.stderr)
    print(json.dumps({
        "converged": result.converged,
        "iters": result.iters,
        "relative_residual_norm": result.relative_residual_norm,
        "solve_time_s": result.solve_time_s,
    }))

    if args.write_iters_and_residuals:
        write_iters_and_residuals(
            result.local_resnorm_history, result.global_resnorm_history,
            result.inner_iters_history, "",
        )
    if args.write_comm_data:
        write_comm_data(result.comm_matrix, result.iters, "comm_data.csv",
                        locality=solver.neighbor_locality())
    if args.timings_file != "null" and result.stage_timings:
        write_timings(result.stage_timings, args.timings_file)
    return 0 if result.converged else 1


if __name__ == "__main__":
    sys.exit(main())
