"""The check that decides ``correct`` fails what it must: the control (the
program one precision below the configuration's) and the faults a cell can
have, each planted under the timed path of a whole run of a tiny cell on
the CPU; beside them the sound run passes.  In the cell of several
processes each worker plants the fault in its own solver (a fault is
found by its module and name), and the exchange between the processes'
cards is one more fault it can have."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, run

CELLS = ["tiny_flagship.rhs_stream", "tiny_direct.rhs_stream"]
GROUP = "tiny_flagship_4proc.rhs_stream"


def step_unchanged(solver):
    """Each step returns its state unchanged: the RAS loop's outer step,
    and FGMRES's preconditioning step."""
    solver._step = lambda st: {**st, "it": st["it"] + 1}
    closures = solver._accel_closures

    def frozen():
        matvec, _ = closures()
        return matvec, torch.zeros_like

    solver._accel_closures = frozen


def half_left_out(solver):
    """Half of the subdomains' interior results left out."""
    extract = solver._extract_int

    def half(z):
        out = extract(z).clone()
        out[out.shape[0] // 2:] = 0
        return out

    solver._extract_int = half


def exchange_left_out(solver):
    """The halo exchange left out: each subdomain's extended iterate holds
    its own window and no neighbour's values."""
    exchange = solver._exchange

    def own_only(x_own):
        out = torch.zeros_like(exchange(x_own))
        for s in range(x_own.shape[0]):
            mine = torch.zeros_like(x_own)
            mine[s] = x_own[s]
            out[s] = exchange(mine)[s]
        return out

    solver._exchange = own_only
    solver._stages["boundary_exchange"] = own_only


def chips_exchange_left_out(solver):
    """The halo rounds between processes left out: ``Mesh.shift`` moves
    the rows that stay in the process and leaves zeros where a peer's
    rows would arrive."""
    mesh = solver.mesh
    D, Dl, p = mesh.num_ranks, mesh.ranks_per_process, mesh.process_index

    def local_only(buf, offset):
        mine = np.arange(p * Dl, (p + 1) * Dl)
        src = (mine - offset) % D
        stay = src // Dl == p
        out = torch.zeros_like(buf)
        out[torch.from_numpy(np.nonzero(stay)[0])] = buf[
            torch.from_numpy(src[stay] - p * Dl)]
        return out

    object.__setattr__(mesh, "shift", local_only)


def answer_altered(solver):
    """One entry of each returned solution altered by one part in 1e4."""
    for name in ("run", "run_accelerated"):
        entry = getattr(solver, name)

        def altered(*a, _entry=entry, **k):
            res = _entry(*a, **k)
            res.solution[len(res.solution) // 2] *= 1 + 1e-4
            return res

        setattr(solver, name, altered)


@pytest.mark.parametrize("cell", CELLS + [GROUP])
def test_control_is_not_correct(tiny_root, cell):
    res = control.control(cell, 2**31 + 99, 0.2, root=tiny_root,
                          device="cpu")
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["rel_residual_max"]["value"] > 1e-7


@pytest.mark.parametrize("fault", [step_unchanged, half_left_out,
                                   exchange_left_out, answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_root, cell, fault):
    sound = run.run_cell(cell, 2**31 + 5, 0.2, False, root=tiny_root,
                         device="cpu")["result"]
    assert sound["correct"] is True
    res = run.run_cell(cell, 2**31 + 5, 0.2, False, root=tiny_root,
                       device="cpu", program_hook=fault)["result"]
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["rel_residual_max"]["value"] > 1e-8


@pytest.mark.parametrize("fault", [step_unchanged, half_left_out,
                                   exchange_left_out, chips_exchange_left_out,
                                   answer_altered])
def test_fault_across_processes_is_not_correct(tiny_root, fault):
    """Each fault planted in every worker of the group cell; its sound
    run on this seed is ``test_portbench_group``'s."""
    res = run.run_cell(GROUP, 2**31 + 5, 0.2, False, root=tiny_root,
                       device="cpu", program_hook=fault)["result"]
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["rel_residual_max"]["value"] > 1e-8
