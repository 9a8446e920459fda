"""The port's examples (``schwarz_tpu_torch/examples/``) on the CPU: the two
synchronous tours held to the JAX package's ``solve`` on the same Settings
(equal iteration counts and convergence), the stale-halo and free-running
tours to convergence; each also through ``python -m`` as a user runs it."""

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest

import schwarz_tpu.config as jcfg
import schwarz_tpu.models as jmodels
from schwarz_tpu.ras import solve as jsolve
from schwarz_tpu_torch.examples import (advanced_async, free_running_async,
                                        optimized_schwarz, poisson_basic)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_settings(obj):
    """The JAX package's counterpart of a port ``Settings`` (or of one of
    its nested settings), field by field, enums by value."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jcfg, type(v).__name__)(v.value)
        elif dataclasses.is_dataclass(v):
            v = jax_settings(v)
        kw[f.name] = v
    return getattr(jcfg, type(obj).__name__)(**kw)


def test_poisson_basic_matches_jax(capsys):
    rt = poisson_basic.main("cpu")
    A = jmodels.laplacian_2d(64)
    rj = jsolve(A, jmodels.generate_rhs(A.n),
                jax_settings(poisson_basic.SETTINGS), 4)
    assert rt.converged and rj.converged
    assert rt.iters == rj.iters
    assert rt.relative_residual_norm <= 1e-8
    assert f"in {rt.iters} outer iterations" in capsys.readouterr().out


def test_optimized_schwarz_matches_jax():
    results = optimized_schwarz.main("cpu")
    for name, op, n, settings, S in optimized_schwarz.SOLVES:
        A = getattr(jmodels, op)(n)
        rj = jsolve(A, jmodels.generate_rhs(A.n), jax_settings(settings), S)
        rt = results[name]
        assert (rt.iters, rt.converged) == (rj.iters, rj.converged), name
        if rt.converged:
            assert rt.relative_residual_norm <= 10 * settings.tolerance, name


def test_advanced_async_converges_and_resumes():
    first, again = advanced_async.main("cpu")
    assert first.converged and again.converged
    # the float32 halos floor the true residual near the tolerance
    assert first.relative_residual_norm < 5e-5
    assert again.iters == first.iters
    np.testing.assert_array_equal(again.solution, first.solution)


def test_free_running_async_converges():
    out = free_running_async.main("cpu")
    x, info = out["plain"]
    assert info["converged"] and info["relative_residual_norm"] < 1e-4
    _, rinfo = out["refined"]
    assert rinfo["converged"] and rinfo["relative_residual_norm"] <= 1e-12
    for k in ("oras", "classical", "nonsym"):
        assert out[k][1]["converged"], k
    assert out["oras"][1]["rounds"] <= out["classical"][1]["rounds"]


@pytest.mark.parametrize("flags, code", [(["--device", "cpu"], 0), ([], 1)])
def test_poisson_basic_command_line(flags, code):
    """``python -m``, as a user runs it: on the CPU when asked, and without
    a card and without ``--device`` it raises."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "schwarz_tpu_torch.examples.poisson_basic",
         *flags], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == code, out.stderr
    if code:
        assert "CUDA" in out.stderr
    else:
        assert "converged=True" in out.stdout
