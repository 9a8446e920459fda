"""The port's command line (``python -m schwarz_tpu_torch``) against
the JAX package's (``schwarz_tpu/cli.py``), on the CPU.

The parsers accept the same option strings with the same defaults and
choices, and map every argv list of ``tests/test_cli.py`` (plus the FEM,
coarse, free-running, direct-locals and accelerator flags) onto equal
``Settings``.  ``main([..., "--executor", "cpu"])`` of both packages, each
in its own working directory, prints equal JSON lines (``converged`` and
``iters`` exactly, the residual within 1e-8 relative) and writes equal
files: ``comm_data.csv`` and ``perm.csv`` byte for byte, each
``iter_res_XX.csv`` with the same rows within 1e-8, and timing CSVs with
the same stage rows.  The free-running branch is held to the port's own
``make_free_running_solver`` run, which other tests hold to the JAX
package.
"""

import csv
import dataclasses
import enum
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import schwarz_tpu.cli as jcli
import schwarz_tpu_torch.cli as tcli
from schwarz_tpu_torch.utils.backend import ExecutorError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every argv list of tests/test_cli.py, then the flags it does not reach
ARGVS = [
    [],
    ["--local_solver", "iterative-ginkgo"],
    ["--local_solver", "direct-cholmod"],
    ["--local_solver", "direct-umfpack"],
    ["--local_solver", "cg", "--non_symmetric_matrix"],
    ["--enable_onesided", "--global_convergence_type", "decentralized",
     "--enable_comm_overlap_staleness", "3"],
    ["--enable_onesided"],
    ["--use_mixed_precision", "--dtype", "float64",
     "--local_compute_dtype", "float32"],
    ["--use_precond", "--precond", "jacobi"],
    ["--use_precond", "--precond_max_block_size", "8"],
    ["--comm_strategy", "neighbor", "--local_convergence_crit",
     "residual-based", "--enable_overlap"],
    ["--two_level", "--accelerator", "fgmres"],
    ["--no-enable_global_check"],
    ["--local_precond", "isai"],
    ["--local_precond", "block-jacobi"],
    ["--local_factorization", "umfpack"],
    ["--local_factorization", "cholmod"],
    ["--no-enable_twosided"],
    ["--enable_debug_write"],
    ["--local_precond", "parilu"],
    ["--local_precond", "ilu", "--ilu_sweeps", "5"],
    ["--executor", "cpu", "--set_1d_laplacian_size", "20",
     "--num_subdomains", "4", "--num_iters", "3"],
    # FEM problems
    ["--problem", "fem", "--fem_refine_levels", "3", "--fem_eps", "10",
     "--partition", "metis"],
    ["--problem", "fem_advection"],
    ["--problem", "fem_elasticity", "--local_solver", "lu"],
    # coarse space
    ["--two_level", "--coarse_space", "spectral", "--coarse_aggregates",
     "32", "--coarse_solver", "cg"],
    ["--oras_weight", "auto", "--two_level"],
    ["--oras_weight", "-0.5", "--dia_max_diags", "8", "--inner_operator",
     "dia_only"],
    # free-running
    ["--free_running", "--async_chunk_rounds", "4", "--fresh_read",
     "--async_ninner", "8", "--enable_onesided",
     "--enable_comm_overlap_staleness", "2"],
    # direct locals
    ["--local_solver", "cholesky", "--direct_apply", "inverse",
     "--enable_overlap_split"],
    ["--local_solver", "cholesky", "--direct_apply", "blocked",
     "--local_reordering", "metis_reordering", "--factor_ordering_natural"],
    # accelerator, comm, precision and the flagship's flags
    ["--accelerator", "fgmres", "--restart_iter", "20", "--instrument"],
    ["--comm_strategy", "rdma", "--fused_local_cg", "--dtype", "float32",
     "--remote_comm_type", "put", "--enable_one_by_one", "--flush_type",
     "flush-local"],
    ["--set_1d_laplacian_size", "512", "--num_subdomains", "16",
     "--overlap", "6", "--set_tol", "1e-8", "--num_iters", "200",
     "--local_compute_dtype", "float32", "--local_tol", "1e-6",
     "--local_max_iters", "20", "--use_precond", "--precond", "fsai",
     "--two_level", "--coarse_space", "spectral", "--coarse_aggregates",
     "32", "--enable_global_check_iter_offset", "--reset_local_crit_iter",
     "4", "--enable_logging", "--num_threads", "4"],
]


def _flat(v):
    """Settings as plain values: nested dataclasses as dicts, enums by
    ``.value``."""
    if dataclasses.is_dataclass(v):
        return {f.name: _flat(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    return v.value if isinstance(v, enum.Enum) else v


def _options(parser):
    out = {}
    for a in parser._actions:
        for o in a.option_strings:
            out[o] = (a.default, tuple(a.choices) if a.choices else None,
                      a.nargs, type(a).__name__)
    return out


def test_option_strings_equal_jax():
    j, t = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert set(t) == set(j)
    for o in j:
        assert t[o] == j[o], o


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "[]")
def test_settings_from_args_equal_jax(argv):
    js = jcli.settings_from_args(jcli.build_parser().parse_args(argv))
    ts = tcli.settings_from_args(tcli.build_parser().parse_args(argv))
    assert _flat(ts) == _flat(js)


def test_unknown_local_solver_exits_as_jax():
    argv = ["--local_solver", "bogus"]
    with pytest.raises(SystemExit) as ej:
        jcli.settings_from_args(jcli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as et:
        tcli.settings_from_args(tcli.build_parser().parse_args(argv))
    assert str(et.value) == str(ej.value)
    assert str(et.value).startswith("error: unknown --local_solver")


def _run(main, argv, where, monkeypatch, capsys):
    where.mkdir()
    monkeypatch.chdir(where)
    rc = main(argv + ["--executor", "cpu"])
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    return rc, json.loads(lines[0]), err


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


MAIN_CASES = {
    "default_hints": ["--set_1d_laplacian_size", "20", "--num_subdomains",
                      "4", "--num_iters", "3"],
    "two_level_spectral": ["--set_1d_laplacian_size", "16",
                           "--num_subdomains", "4", "--overlap", "3",
                           "--two_level", "--coarse_space", "spectral",
                           "--coarse_aggregates", "2", "--instrument",
                           "--timings_file", "t.csv"],
    "fgmres_instrument": ["--set_1d_laplacian_size", "24",
                          "--num_subdomains", "4", "--overlap", "2",
                          "--accelerator", "fgmres", "--restart_iter", "20",
                          "--instrument", "--timings_file", "t.csv"],
    "fem_metis": ["--problem", "fem", "--set_1d_laplacian_size", "16",
                  "--partition", "metis", "--overlap", "2", "--num_iters",
                  "300", "--num_subdomains", "4"],
}
FILES = ["--write_iters_and_residuals", "--write_comm_data",
         "--write_perm_data"]


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_matches_jax(case, tmp_path, monkeypatch, capsys):
    argv = MAIN_CASES[case] + FILES
    rc_j, out_j, err_j = _run(jcli.main, argv, tmp_path / "j", monkeypatch,
                              capsys)
    rc_t, out_t, err_t = _run(tcli.main, argv, tmp_path / "t", monkeypatch,
                              capsys)
    assert rc_t == rc_j == (0 if out_j["converged"] else 1)
    assert out_t["converged"] == out_j["converged"]
    assert out_t["iters"] == out_j["iters"]
    assert out_t["relative_residual_norm"] == pytest.approx(
        out_j["relative_residual_norm"], rel=1e-8)
    status = [ln for ln in err_t.splitlines() if " in " in ln
              and "iterations" in ln]
    assert status == [ln for ln in err_j.splitlines() if " in " in ln
                      and "iterations" in ln]
    hints = [ln for ln in err_t.splitlines() if "hint: try" in ln]
    assert hints == [ln for ln in err_j.splitlines() if "hint: try" in ln]
    if case == "default_hints":
        assert "did not converge" in err_t and not out_t["converged"]
        assert "hint: try --two_level" in hints[0]
        assert "--oras_weight" in hints[0]
    else:
        assert out_t["converged"]
    j, t = tmp_path / "j", tmp_path / "t"
    for name in ("comm_data.csv", "perm.csv"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    res = sorted(p.name for p in j.glob("iter_res_*.csv"))
    assert len(res) == 4
    assert sorted(p.name for p in t.glob("iter_res_*.csv")) == res
    for name in res:
        rj, rt = _rows(j / name), _rows(t / name)
        assert rt[0] == rj[0] and len(rt) == len(rj), name
        vj = np.array(rj[1:], float)
        vt = np.array(rt[1:], float)
        # iteration numbers exactly; the fgmres run writes zero local
        # residuals and inner counts in both packages
        np.testing.assert_array_equal(vt[:, 0], vj[:, 0])
        scale = np.abs(vj[:, 2]).max()
        np.testing.assert_allclose(vt[:, 1:3], vj[:, 1:3], rtol=1e-8,
                                   atol=1e-12 * scale)
    if "--timings_file" in argv:
        stages_j = sorted(r[0] for r in _rows(j / "t.csv"))
        assert sorted(r[0] for r in _rows(t / "t.csv")) == stages_j
        assert _rows(t / "t.csv")[0] == _rows(j / "t.csv")[0]
    else:
        assert not (t / "t.csv").exists()


def test_free_running_matches_own_solver(tmp_path, monkeypatch, capsys):
    from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
    from schwarz_tpu_torch.ras import make_free_running_solver

    argv = ["--set_1d_laplacian_size", "32", "--num_subdomains", "4",
            "--overlap", "2", "--set_tol", "1e-4", "--num_iters", "600",
            "--free_running", "--async_ninner", "16"]
    rc, out, err = _run(tcli.main, argv, tmp_path / "t", monkeypatch,
                        capsys)
    assert "free-running kernel: AsyncRASolver" in err
    settings = tcli.settings_from_args(tcli.build_parser().parse_args(argv))
    A = laplacian_2d(32)
    fr, refine = make_free_running_solver(
        A, generate_rhs(A.n, random=False), 4, settings, ninner=16,
        chunk_rounds=16,
        fresh_read=False, device="cpu")
    assert not refine
    _, info = fr.run(max_rounds=settings.max_iters)
    assert rc == 0 and out["converged"] and info["converged"]
    assert out["done_at"] == info["done_at"].tolist()
    assert out["iters"] == int(info["done_at"].max())
    assert out["relative_residual_norm"] == info["relative_residual_norm"]
    assert out["relative_residual_norm"] < 1e-3


def test_refused_configuration_exits_with_message(tmp_path, monkeypatch):
    # the fused CG takes float32 locals only: both command lines exit with the
    # solver's message instead of a traceback
    argv = ["--set_1d_laplacian_size", "8", "--num_subdomains", "2",
            "--fused_local_cg", "--executor", "cpu"]
    monkeypatch.chdir(tmp_path)
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert str(e.value).startswith("error: fused_local_cg")


def test_main_without_gpu_raises_executor_error(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    import schwarz_tpu_torch.core.decompose as dmod

    def no_compute(*a, **k):   # pragma: no cover - must not be reached
        raise AssertionError("computed without a device")

    monkeypatch.setattr(dmod, "decompose", no_compute)
    for argv in ([], ["--executor", "cuda"], ["--executor", "auto"]):
        with pytest.raises(ExecutorError, match="--executor cpu"):
            tcli.main(argv + ["--set_1d_laplacian_size", "8"])
    with pytest.raises(ExecutorError, match="unknown executor"):
        tcli.main(["--executor", "tpu"])


def test_python_dash_m_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "schwarz_tpu_torch",
           "--set_1d_laplacian_size", "8", "--num_subdomains", "2"]
    ok = subprocess.run(cmd + ["--executor", "cpu"], cwd=tmp_path, env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout.strip().splitlines()[-1])["converged"]
    no_gpu = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                            text=True, timeout=300)
    assert no_gpu.returncode != 0 and no_gpu.stdout == ""
    assert "ExecutorError" in no_gpu.stderr
    assert "--executor cpu" in no_gpu.stderr
