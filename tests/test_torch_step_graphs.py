"""The synchronous solver's outer iteration as CUDA graphs, on the CPU: the
gate that decides once per solver whether its step is replayed from graphs
(``step_graphs.capturable``), and the state every run writes in place,
which the graphs' addresses need.  The replays themselves run on the card
(``tests/test_torch_cuda.py``); on the CPU every step is eager.  Seconds
in all."""

import types

import numpy as np
import pytest
import torch

import schwarz_tpu_torch.config as cfg
import schwarz_tpu_torch.models as models
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.ras import STATE_KEYS, RASolver
from schwarz_tpu_torch.step_graphs import capturable, step_graph_replay

CUDA = torch.device("cuda")
# the flagship's settings (portbench/configs/flagship_lap2d_512.json)
FLAGSHIP = dict(partition=cfg.Partition.regular, overlap=6,
                local_solver=cfg.LocalSolver.iterative_cg,
                precond=cfg.Precond.fsai, tolerance=1e-8, max_iters=200,
                dtype="float64", local_compute_dtype="float32",
                local_tolerance=1e-6, local_max_iters=20,
                row_pad_multiple=128, two_level=True, coarse_aggregates=32,
                coarse_space="spectral")

# settings over the flagship's, the device, the mesh's processes (None: no
# mesh), whether the local solve reads the host, and whether the step is
# captured
GATE = {
    "flagship": ({}, CUDA, None, False, True),
    "mesh-of-one": ({}, CUDA, 1, False, True),
    "cpu": ({}, torch.device("cpu"), None, False, False),
    "mesh": ({}, CUDA, 2, False, False),
    "coarse-cg": (dict(coarse_solver="cg"), CUDA, None, False, False),
    "rdma": (dict(comm=cfg.CommSettings(strategy=cfg.HaloStrategy.rdma)),
             CUDA, None, False, False),
    "staleness": (dict(two_level=False, comm=cfg.CommSettings(
        onesided=True, staleness=2)), CUDA, None, False, False),
    "reset-local-crit": (dict(reset_local_crit_iter=3), CUDA, None, False,
                         False),
    "local-reads-host": ({}, CUDA, None, True, False),
}


@pytest.mark.parametrize("case", sorted(GATE))
def test_gate(case):
    over, device, processes, reads, want = GATE[case]
    mesh = (None if processes is None
            else types.SimpleNamespace(num_processes=processes))
    s = cfg.Settings(**{**FLAGSHIP, **over})
    assert capturable(s, device, mesh, reads) is want


def _solver(**kw):
    s = cfg.Settings(overlap=2, tolerance=1e-6, max_iters=100, **kw)
    A = models.laplacian_2d(16)
    return A, RASolver(decompose(A, models.generate_rhs(A.n), s, 4),
                       device="cpu")


def _leaves(st):
    out = []
    for k in STATE_KEYS:
        v = st[k]
        out += list(v) if k == "conv" else [v]
    return [t for t in out if isinstance(t, torch.Tensor)]


def test_cpu_solver_has_no_graphs_and_replays_nothing():
    _, solver = _solver()
    assert solver._graphs is None
    n = step_graph_replay.launches
    assert solver.run().converged
    assert step_graph_replay.launches == n


def test_runs_write_one_state_in_place():
    """Every run's state is the same tensors, set afresh: a second run of
    the same rhs gives the first one's result bit for bit, and the
    resumed state a run starts from is left as it was."""
    A, solver = _solver()
    r0 = solver.run()
    st = solver._state
    ptrs = [t.data_ptr() for t in _leaves(st)]
    r1 = solver.run()
    assert solver._state is st
    assert [t.data_ptr() for t in _leaves(st)] == ptrs
    np.testing.assert_array_equal(r1.solution, r0.solution)
    np.testing.assert_array_equal(r1.global_resnorm_history,
                                  r0.global_resnorm_history)
    assert int(st["it_dev"]) == st["it"]
    resume = solver.init_state()
    kept = [t.clone() for t in _leaves(resume)]
    r2 = solver.run(resume_state=resume)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(resume), kept))
    np.testing.assert_array_equal(r2.solution, r0.solution)
    x0 = np.random.default_rng(0).standard_normal(
        (4, solver.meta.max_interior))
    r3 = solver.run(x0=x0)
    fresh = RASolver(solver.dec, device="cpu").run(x0=x0)
    np.testing.assert_array_equal(r3.solution, fresh.solution)
    np.testing.assert_array_equal(r3.global_resnorm_history,
                                  fresh.global_resnorm_history)
