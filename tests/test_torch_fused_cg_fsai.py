"""K3's FSAI mode and the rule that routes the local CG to K3, on the CPU.

The plain FSAI mode of ``fused_cg_solve_plain`` against the batched CG of
``solvers/cg.py`` with the port's plain ``G^T (G r)``; the gate
(``fused_cg_supported``), which takes FSAI only with banded factors; and
the solver's rule: a plan on the card takes K3 whenever the gate holds, a
plan on the CPU keeps the unfused CG unless ``fused_local_cg`` asks for
K3.  The CUDA kernel itself is held to its plain version in
``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from schwarz_tpu_torch import Precond, RASolver, Settings
from schwarz_tpu_torch.core.decompose import decompose
from schwarz_tpu_torch.models import generate_rhs, laplacian_2d
from schwarz_tpu_torch.ops.dia_kernel import dia_spmv_chain_plain
from schwarz_tpu_torch.ops.fused_cg import (fused_cg_solve,
                                            fused_cg_solve_plain,
                                            fused_cg_supported)
from schwarz_tpu_torch.solvers import local
from schwarz_tpu_torch.solvers.cg import cg_solve

# the flagship recipe's local solve (FSAI(0)-CG, float32 locals capped at
# 20) at 16^2 on 2 strips, one level
FLAGSHIP_LOCALS = dict(
    overlap=2, tolerance=1e-8, max_iters=200, dtype="float64",
    local_compute_dtype="float32", local_tolerance=1e-6, local_max_iters=20,
    precond=Precond.fsai, row_pad_multiple=128, spmv_format="dia")


def _solver(**kw):
    A = laplacian_2d(16)
    s = Settings(**{**FLAGSHIP_LOCALS, **kw})
    return RASolver(decompose(A, generate_rhs(A.n), s, 2), device="cpu")


@pytest.fixture(scope="module")
def plan_solver():
    return _solver()


@pytest.mark.parametrize("mode", ["none", "jacobi", "fsai"])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_modes_equal_the_batched_cg(plan_solver, mode, warm):
    """Each mode of the plain version is ``cg_solve`` with that
    preconditioner over the plain DIA product: the same iterations and the
    same x; the wrapper on CPU tensors takes it.  The last subdomain has a
    zero rhs (from x0 = 0) and never iterates."""
    t = plan_solver._local
    p = t.plan
    dia = p["dia_vals_lc"]
    S, _, R = dia.shape
    rng = np.random.default_rng(3)
    b = torch.tensor(rng.standard_normal((S, R)), dtype=torch.float32)
    x0 = torch.zeros_like(b)
    if warm:
        x0 = 0.1 * torch.tensor(rng.standard_normal((S, R)),
                                dtype=torch.float32)
    else:
        b[-1] = 0.0
    go, uo = t.fsai_offsets
    gd, ud = p["fsai_gl_dia"], p["fsai_gu_dia"]
    dinv = 1.0 / dia[:, t.dia_offsets.index(0)]
    dinv_arg = dinv if mode == "jacobi" else None
    fsai = (go, gd, uo, ud) if mode == "fsai" else None
    precond = {"none": None, "jacobi": lambda r: dinv * r,
               "fsai": lambda r: dia_spmv_chain_plain(go, gd, uo, ud, r)}[mode]
    ref = cg_solve(None, None, b, x0, 1e-6, 20, precond=precond,
                   apply_fn=t.operator(inner=True))
    got = fused_cg_solve_plain(t.dia_offsets, dia, b, x0, dinv_arg, 1e-6, 20,
                               fsai)
    n0 = fused_cg_solve.launches
    wrapped = fused_cg_solve(t.dia_offsets, dia, b, x0, dinv_arg, 1e-6, 20,
                             cluster=8, fsai=fsai)
    assert fused_cg_solve.launches == n0     # the CPU launches nothing
    for r in (got, wrapped):
        assert torch.equal(r.iters, ref.iters)
        torch.testing.assert_close(r.x, ref.x, rtol=0, atol=0)
        torch.testing.assert_close(r.rel_resnorm, ref.rel_resnorm)
    if not warm:
        assert int(got.iters[-1]) == 0
    assert int(got.iters.max()) > 0


def test_plain_fsai_mode_is_the_solvers_preconditioner(plan_solver):
    """The solver's own FSAI apply (``LocalSolve.precond``) is the plain
    chain."""
    t = plan_solver._local
    go, uo = t.fsai_offsets
    r = torch.randn(t.plan["fsai_gl_dia"].shape[0::2])
    assert torch.equal(t.precond(r), dia_spmv_chain_plain(
        go, t.plan["fsai_gl_dia"], uo, t.plan["fsai_gu_dia"], r))


def test_plain_refuses_jacobi_and_fsai_at_once(plan_solver):
    t = plan_solver._local
    p = t.plan
    b = torch.zeros(p["dia_vals_lc"].shape[0::2])
    go, uo = t.fsai_offsets
    with pytest.raises(ValueError, match="Jacobi and FSAI"):
        fused_cg_solve(t.dia_offsets, p["dia_vals_lc"], b, b, b,
                       1e-6, 5, fsai=(go, p["fsai_gl_dia"], uo,
                                      p["fsai_gu_dia"]))


@pytest.mark.parametrize("precond,factors_dia,want", [
    ("none", False, True), ("jacobi", False, True), ("fsai", True, True),
    ("fsai", False, False), ("ilu", True, False),
    ("block_jacobi", True, False),
])
def test_gate_takes_fsai_only_with_banded_factors(precond, factors_dia, want):
    assert fused_cg_supported(16, 21504, 5, torch.float32, False, precond,
                              factors_dia=factors_dia) == want
    # the other clauses hold for FSAI as for Jacobi
    assert not fused_cg_supported(16, 21504, 5, torch.float64, False,
                                  precond, factors_dia=factors_dia)
    assert not fused_cg_supported(16, 21504, 5, torch.float32, True,
                                  precond, factors_dia=factors_dia)
    assert not fused_cg_supported(16, 21500, 5, torch.float32, False,
                                  precond, factors_dia=factors_dia)


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_plan_takes_k3_only_when_asked(plan_solver, fused, monkeypatch):
    """On the CPU the flagship's locals pass the gate, yet the plan keeps
    the unfused CG with the solver's own preconditioner unless
    ``fused_local_cg`` asks for K3, which FSAI now passes (on CPU tensors
    its plain version, a CG of the same arithmetic): the same solve."""
    calls = []

    def counted(*a, **k):
        calls.append(k.get("fsai") is not None)
        return fused_cg_solve(*a, **k)

    monkeypatch.setattr(local, "fused_cg_solve", counted)
    t = _solver(fused_local_cg=True) if fused else plan_solver
    assert t._local.use_fused_cg == fused
    res = t.run()
    assert res.converged and res.relative_residual_norm <= 1e-8
    assert len(calls) == (res.iters if fused else 0) and all(calls)
    if fused:
        ref = plan_solver.run()
        assert res.iters == ref.iters
        np.testing.assert_array_equal(res.global_resnorm_history,
                                      ref.global_resnorm_history)


def test_fused_request_still_raises_outside_the_gate():
    with pytest.raises(ValueError, match=r"fsai\)"):
        _solver(fused_local_cg=True, local_compute_dtype=None)
