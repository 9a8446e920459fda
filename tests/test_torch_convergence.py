"""The port's ``tree`` and ``decentralized`` convergence protocols against the
JAX package's, on the CPU: whole solves (iteration counts and local residual
histories) and the protocol state round by round on a scripted sequence of
locally-converged flags."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import schwarz_tpu.config as jcfg
from schwarz_tpu.core.decompose import decompose as jdecompose
from schwarz_tpu.models import generate_rhs, laplacian_2d
from schwarz_tpu.parallel import convergence as jconv
from schwarz_tpu.parallel.mesh import SUBD_AXIS, make_mesh
from schwarz_tpu.ras import RASolver as JSolver
import schwarz_tpu_torch.config as tcfg
from schwarz_tpu_torch.core.decompose import decompose as tdecompose
from schwarz_tpu_torch.parallel import convergence as tconv
from schwarz_tpu_torch.ras import RASolver as TSolver

# method, enable_accumulate
PROTOCOLS = [("tree", False), ("decentralized", False),
             ("decentralized", True)]


def _settings(cfg, method, accumulate, put_all, **kw):
    return cfg.Settings(convergence=cfg.ConvergenceSettings(
        method=cfg.GlobalConvergence(method), enable_accumulate=accumulate,
        put_all_local_residual_norms=put_all), **kw)


@pytest.mark.parametrize("S", [4, 7])
@pytest.mark.parametrize("put_all", [True, False])
@pytest.mark.parametrize("method,accumulate", PROTOCOLS)
def test_protocol_solve_matches_jax(method, accumulate, put_all, S):
    """S = 4 is a tree with a one-child node (node 1 has a left child
    only), S = 7 a full tree of three levels."""
    A = laplacian_2d(12)
    b = generate_rhs(A.n)
    kw = dict(overlap=2, tolerance=1e-6, max_iters=200)
    rj = JSolver(jdecompose(
        A, b, _settings(jcfg, method, accumulate, put_all, **kw), S),
        mesh=make_mesh(jax.devices()[:S])).run()
    rt = TSolver(tdecompose(
        A, b, _settings(tcfg, method, accumulate, put_all, **kw), S),
        device="cpu").run()
    assert rj.converged and rt.converged
    assert rt.iters == rj.iters
    assert rt.local_resnorm_history.shape == rj.local_resnorm_history.shape
    np.testing.assert_allclose(
        rt.local_resnorm_history, rj.local_resnorm_history, rtol=1e-8,
        atol=1e-8 * np.abs(rj.local_resnorm_history).max())
    np.testing.assert_allclose(rt.global_resnorm_history,
                               rj.global_resnorm_history, rtol=1e-8)
    # detection by these protocols lags the allgather test by the rounds
    # the news needs to travel
    ra = TSolver(tdecompose(A, b, tcfg.Settings(**kw), S),
                 device="cpu").run()
    assert rt.iters >= ra.iters


def _script(S, rounds, seed):
    """Scripted inputs: residual norms that shrink at a rate of their own,
    locally-converged flags that come on one subdomain at a time (and
    flicker once), a chain adjacency with one long link."""
    rng = np.random.default_rng(seed)
    rn = rng.random((rounds, S)) + 0.5 ** np.arange(rounds)[:, None]
    lc = np.zeros((rounds, S), bool)
    order = rng.permutation(S)
    for r in range(rounds):
        lc[r, order[: min(S, r)]] = True
    lc[3, order[0]] = False             # a flag that drops again
    adj = np.zeros((S, S), bool)
    for i in range(S):
        for j in (i - 1, i + 1):
            if 0 <= j < S:
                adj[i, j] = True
    adj[0, S - 1] = True
    return rn, lc, adj


@pytest.mark.parametrize("S", [4, 7])
@pytest.mark.parametrize("put_all", [True, False])
@pytest.mark.parametrize("method,accumulate", PROTOCOLS + [
    ("allgather", False), ("allreduce", False)])
def test_conv_state_round_by_round(method, accumulate, put_all, S):
    rounds = 12
    rn, lc, adj = _script(S, rounds, seed=S)
    sj = _settings(jcfg, method, accumulate, put_all, tolerance=1e-3)
    st_ = _settings(tcfg, method, accumulate, put_all, tolerance=1e-3)

    spec = jconv.ConvState(**{
        f: (P() if f == "global_resnorm0" else P(SUBD_AXIS))
        for f in jconv.ConvState._fields})
    step_j = jax.jit(jax.shard_map(
        lambda st, r, r0, c, a: jconv.conv_step(sj, S, st, r, r0, c, a),
        mesh=make_mesh(jax.devices()[:S]),
        in_specs=(spec, P(SUBD_AXIS), P(SUBD_AXIS), P(SUBD_AXIS),
                  P(SUBD_AXIS)),
        out_specs=(spec, P(), P()), check_vma=False))

    state_j = jconv.init_conv_state(S, S, jnp.float64)
    state_t = tconv.init_conv_state(S, torch.float64, "cpu")
    assert tconv.ConvState._fields == jconv.ConvState._fields
    adj_t = torch.tensor(adj)
    seen_all = False
    for r in range(rounds):
        state_j, n_j, g_j = step_j(state_j, jnp.asarray(rn[r]),
                                   jnp.asarray(rn[0]), jnp.asarray(lc[r]),
                                   jnp.asarray(adj))
        state_t, n_t, g_t = tconv.conv_step(
            st_, S, state_t, torch.tensor(rn[r]), torch.tensor(rn[0]),
            torch.tensor(lc[r]), adj_t)
        assert int(n_t) == int(n_j), (r, int(n_t), int(n_j))
        assert n_t.dtype == torch.int32
        np.testing.assert_allclose(float(g_t), float(g_j), rtol=1e-14)
        for f in jconv.ConvState._fields:
            a, b = np.asarray(getattr(state_j, f)), getattr(state_t, f)
            assert a.shape == tuple(b.shape), (r, f)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-14,
                                           err_msg=f"round {r}: {f}")
            else:
                np.testing.assert_array_equal(b.numpy(), a,
                                              err_msg=f"round {r}: {f}")
        seen_all = seen_all or int(n_t) == S
    if method != "allgather":
        # every flag is on from round S: each protocol detects within the
        # script (a tree of 7 needs 3 levels up and 2 down)
        assert seen_all
