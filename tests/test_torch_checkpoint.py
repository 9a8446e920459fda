"""The synchronous solver's state methods against the JAX package's, on the
CPU: checkpoints (``save_checkpoint`` / ``load_checkpoint``, ``run(
resume_state=, checkpoint_path=)``, ``write_debug_out``) in the JAX
package's ``.npz`` format, and ``set_rhs``.

A checkpoint written by either package resumes in the other to the
uninterrupted run's history (float64, within rtol 1e-8 plus an atol of
1e-12 of the largest entry, at an outer tolerance of 1e-6); the port
resumes its own bit for bit.
"""

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as spla

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
import schwarz_tpu_torch.models as tmodels
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.ras import STATE_KEYS, RASolver as TSolver
from test_torch_local_solvers import settings

BASE = dict(overlap=3, tolerance=1e-6, max_iters=200)


def _solvers(n=12, S=4, **kw):
    kw = {**BASE, **kw}
    A = tmodels.laplacian_2d(n)
    b = tmodels.generate_rhs(A.n)
    return (JSolver(jdecompose(A, b, settings(jcfg, **kw), S)),
            TSolver(tdecompose(A, b, settings(tcfg, **kw), S), device="cpu"))


def _close(h, want):
    np.testing.assert_allclose(h, want, rtol=1e-8,
                               atol=1e-12 * np.abs(want).max())


def test_leaf_order_is_the_jax_flatten_order():
    js, ts = _solvers()
    flat, _ = jax.tree.flatten(js.init_state())
    template = ts.init_state()
    ours = []
    for k in STATE_KEYS:
        ours += list(template[k]) if k == "conv" else [template[k]]
    assert len(ours) == len(flat)
    for a, b in zip(ours, flat):
        a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
        assert a.shape == np.shape(b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_either_package(tmp_path, writer):
    """5 iterations, a checkpoint, and a resume by the other package (and
    by the same one) with the full budget: the uninterrupted history."""
    js, ts = _solvers()
    full = ts.run()
    _close(full.global_resnorm_history, js.run().global_resnorm_history)
    jshort, tshort = _solvers(max_iters=5)
    path = str(tmp_path / "state.npz")
    short = (jshort if writer == "jax" else tshort).run(checkpoint_path=path)
    assert not short.converged and short.iters == 5
    rt = ts.run(resume_state=ts.load_checkpoint(path))
    rj = js.run(resume_state=js.load_checkpoint(path))
    for r in (rt, rj):
        assert r.converged and r.iters == full.iters
        _close(r.global_resnorm_history, full.global_resnorm_history)
        _close(r.solution, full.solution)
    if writer == "port":
        np.testing.assert_array_equal(rt.global_resnorm_history,
                                      full.global_resnorm_history)
        np.testing.assert_array_equal(rt.solution, full.solution)


def test_checkpoint_round_trip_and_refit(tmp_path):
    """Every leaf survives a save and a load; a solver with a larger
    ``max_iters`` re-fits the histories; a leaf of the wrong width
    raises."""
    _, ts = _solvers(n=8, S=2, overlap=2, max_iters=3)
    path = str(tmp_path / "s.npz")
    ts.run(checkpoint_path=path)
    st = ts.load_checkpoint(path)
    assert st["it"] == 3 and st["it_stop"] == 3
    assert st["x_own"].shape == (2, ts.meta.max_interior)
    path2 = str(tmp_path / "s2.npz")
    ts.save_checkpoint(st, path2)
    with np.load(path) as a, np.load(path2) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    _, big = _solvers(n=8, S=2, overlap=2, max_iters=50)
    sb = big.load_checkpoint(path)
    assert sb["hist_global"].shape == (51,)
    np.testing.assert_array_equal(sb["hist_global"][:4].numpy(),
                                  st["hist_global"].numpy())
    _, wide = _solvers(n=8, S=4, overlap=2, max_iters=3)
    with pytest.raises(ValueError, match="incompatible"):
        wide.load_checkpoint(path)


def test_write_debug_out_dumps_the_final_state(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, ts = _solvers(n=8, S=2, overlap=2, write_debug_out=True)
    r = ts.run()
    st = ts.load_checkpoint(str(tmp_path / "schwarz_debug_out.npz"))
    assert st["it"] == r.iters + 1 and st["nconv"] == 2


def test_set_rhs_matches_a_fresh_solver_and_jax():
    """A new rhs on the built two-level solver (metis partition: the rhs is
    permuted) equals a fresh solver on that rhs, in the port and in the
    JAX package; and back."""
    kw = dict(overlap=3, tolerance=1e-6, max_iters=400, two_level=True,
              coarse_aggregates=2, partition="metis")
    A = tmodels.laplacian_2d(20)
    b1 = tmodels.generate_rhs(A.n)
    b2 = np.random.default_rng(7).standard_normal(A.n)
    ts = TSolver(tdecompose(A, b1, settings(tcfg, **kw), 4), device="cpu")
    js = JSolver(jdecompose(A, b1, settings(jcfg, **kw), 4))
    r1 = ts.run()
    ts.set_rhs(b2)
    js.set_rhs(b2)
    r2, rj2 = ts.run(), js.run()
    fresh = TSolver(tdecompose(A, b2, settings(tcfg, **kw), 4),
                    device="cpu").run()
    assert r2.converged and r2.iters == fresh.iters == rj2.iters
    np.testing.assert_array_equal(r2.global_resnorm_history,
                                  fresh.global_resnorm_history)
    _close(r2.global_resnorm_history, rj2.global_resnorm_history)
    x2 = spla.spsolve(A.to_scipy().tocsc(), b2)
    np.testing.assert_allclose(r2.solution, x2, rtol=1e-4, atol=1e-5)
    ts.set_rhs(b1)
    np.testing.assert_array_equal(ts.run().solution, r1.solution)


@pytest.mark.parametrize("local", ["cholesky", "cg"])
def test_set_rhs_under_overlap_split_recomputes_z_base(local):
    """Under ``comm.overlap_split`` the port's ``set_rhs`` recomputes the
    hoisted ``z_base``: its solve equals a fresh port solver's and a fresh
    JAX solver's on the new rhs.  (The JAX package's own ``set_rhs`` keeps
    the old ``z_base`` and its split solve does not detect; it is not the
    comparison here.)"""
    kw = dict(overlap=2, tolerance=1e-8, max_iters=500, overlap_split=True)
    if local == "cholesky":
        kw.update(local_solver="cholesky", direct_apply="inverse")
    else:
        kw.update(local_max_iters=50)
    A = tmodels.laplacian_2d(24)
    b1 = tmodels.generate_rhs(A.n)
    b2 = tmodels.generate_rhs(A.n, seed=7)
    ts = TSolver(tdecompose(A, b1, settings(tcfg, **kw), 4), device="cpu")
    assert ts.run().converged
    ts.set_rhs(b2)
    r2 = ts.run()
    fresh = TSolver(tdecompose(A, b2, settings(tcfg, **kw), 4),
                    device="cpu").run()
    rj = JSolver(jdecompose(A, b2, settings(jcfg, **kw), 4)).run()
    assert r2.converged and r2.iters == fresh.iters == rj.iters
    np.testing.assert_array_equal(r2.global_resnorm_history,
                                  fresh.global_resnorm_history)
    assert r2.relative_residual_norm <= 1e-8


def test_set_rhs_fgmres():
    kw = dict(overlap=3, tolerance=1e-8, max_iters=300, restart_iter=20,
              precond="block_jacobi")
    A = tmodels.laplacian_2d(16)
    b2 = np.sin(np.arange(A.n) * 0.1)
    ts = TSolver(tdecompose(A, tmodels.generate_rhs(A.n),
                            settings(tcfg, **kw), 4), device="cpu")
    ts.run_accelerated()
    ts.set_rhs(b2)
    r2 = ts.run_accelerated()
    fresh = TSolver(tdecompose(A, b2, settings(tcfg, **kw), 4),
                    device="cpu").run_accelerated()
    assert r2.converged and r2.iters == fresh.iters
    np.testing.assert_array_equal(r2.solution, fresh.solution)


def test_set_rhs_rejects_wrong_size():
    _, ts = _solvers(n=16)
    with pytest.raises(ValueError, match="entries"):
        ts.set_rhs(np.ones(16 * 16 + 1))
