"""The port's indexed gather/scatter (``ops/gather_scatter.py``) against the
JAX package's, and its probe (``ops/native_gate.py``) with the JAX gate's
semantics (``tests/test_native_gate.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schwarz_tpu.ops.gather_scatter as jgs
from schwarz_tpu_torch.ops import GatherOp, gather_values, scatter_values
from schwarz_tpu_torch.ops import native_gate

OPS = ["copy", "add", "diff", "avg"]


def _inputs(seed, n_from=13, n_into=11, n_idx=7, unique=False):
    rng = np.random.default_rng(seed)
    idx = (rng.permutation(n_into)[:n_idx] if unique
           else rng.integers(0, n_from, size=n_idx))
    return (idx.astype(np.int64), rng.standard_normal(n_from),
            rng.standard_normal(n_into))


@pytest.mark.parametrize("num", [None, 0, 4, 7])
@pytest.mark.parametrize("op", OPS)
def test_gather_values_matches_jax(op, num):
    idx, frm, into = _inputs(1)
    want = np.asarray(jgs.gather_values(
        num, jnp.asarray(idx), jnp.asarray(frm), jnp.asarray(into),
        jgs.GatherOp(op)))
    into_t = torch.from_numpy(into.copy())
    got = gather_values(num, torch.from_numpy(idx), torch.from_numpy(frm),
                        into_t, GatherOp(op))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(into_t.numpy(), into)   # not in place


@pytest.mark.parametrize("num", [None, 0, 4, 7])
@pytest.mark.parametrize("op", OPS)
def test_scatter_values_matches_jax(op, num):
    # unique targets for copy/avg (duplicate sets have no defined order in
    # either package); add/diff accumulate duplicates
    unique = op in ("copy", "avg")
    idx, frm, into = _inputs(2, n_from=9, unique=unique)
    if not unique:
        idx = idx % into.shape[0]
    want = np.asarray(jgs.scatter_values(
        num, jnp.asarray(idx), jnp.asarray(frm), jnp.asarray(into),
        jgs.GatherOp(op)))
    into_t = torch.from_numpy(into.copy())
    got = scatter_values(num, torch.from_numpy(idx), torch.from_numpy(frm),
                         into_t, GatherOp(op))
    assert got.shape == into_t.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(into_t.numpy(), into)


def test_gather_op_values_match_jax():
    assert [(m.name, m.value) for m in GatherOp] == [
        (m.name, m.value) for m in jgs.GatherOp]


@pytest.fixture
def fresh_cache():
    native_gate.reset_cache()
    yield
    native_gate.reset_cache()


def test_probe_pass_and_compare(fresh_cache):
    ok, reason = native_gate.native_probe(
        ("t1",), lambda: torch.arange(8.0), compare=lambda: torch.arange(8.0))
    assert ok and reason is None


def test_probe_catches_exceptions_as_negative_answer(fresh_cache):
    def boom():
        raise RuntimeError("kernel failed to launch: nope")

    ok, reason = native_gate.native_probe(("t2",), boom)
    assert not ok
    assert "RuntimeError" in reason and "launch" in reason


def test_probe_detects_result_mismatch(fresh_cache):
    ok, reason = native_gate.native_probe(
        ("t3",), lambda: torch.zeros(4), compare=lambda: torch.ones(4))
    assert not ok
    assert reason == "native result mismatch vs reference path"


def test_probe_caches_per_key(fresh_cache):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.ones(3)
    for _ in range(3):
        ok, _ = native_gate.native_probe(("t4",), fn, x,
                                         compare=lambda x: x + x)
        assert ok
    assert len(calls) == 1
    # a different key probes again; a cached negative answer stays
    native_gate.native_probe(("t5",), fn, x)
    assert len(calls) == 2
    bad = native_gate.native_probe(("t6",), fn, x, compare=lambda x: x)
    assert bad == native_gate.native_probe(("t6",), fn, x) == (
        False, "native result mismatch vs reference path")
    assert len(calls) == 3
    native_gate.reset_cache()
    native_gate.native_probe(("t4",), fn, x)
    assert len(calls) == 4


def test_probe_compares_half_precision(fresh_cache):
    x = torch.arange(6, dtype=torch.bfloat16)
    assert native_gate.native_probe(("t7",), lambda: x.clone(),
                                    compare=lambda: x.clone()) == (True, None)


def test_solver_path_never_calls_the_probe():
    # the port keeps no fallback: no module on the solver path consults
    # the probe to pick a plain version
    import pathlib

    import schwarz_tpu_torch

    root = pathlib.Path(schwarz_tpu_torch.__file__).parent
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "native_probe" in p.read_text()
                   and p.name != "native_gate.py")
    assert users == [], users
