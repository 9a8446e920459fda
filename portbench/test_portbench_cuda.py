"""The benchmark's path on the card at a tiny size: a traced run reads
every metric of its cell from the device trace and the counters, each
roofline share at most 100%, and the control fails there too.  The cell
of several processes runs its 4 processes on the one card: its launcher
is told that the card is 4, and the workers, which see the one card,
share it.  Marked ``cuda``; each test decides when it runs whether a card
is there."""

from __future__ import annotations

import pytest

from portbench import control, registry, run

pytestmark = pytest.mark.cuda

CELLS = {"tiny_flagship.rhs_stream": {"outer_iters", "k1_launches_per_iter",
                                      "local_solve_share", "k1_roofline",
                                      "k2_roofline", "device_idle",
                                      "solve_s.host_bound"},
         "tiny_direct.rhs_stream": {"outer_iters", "k1_launches_per_iter",
                                    "inverse_apply_roofline", "k1_roofline",
                                    "k2_roofline", "device_idle"},
         "tiny_flagship_4proc.rhs_stream": {
             "outer_iters", "k1_launches_per_iter", "k1_roofline",
             "k2_roofline", "device_idle", "solve_s.host_bound",
             "collective_ms_per_iter", "collective_calls_per_iter"}}


@pytest.fixture
def card():
    if not run.torch_cuda_available():
        pytest.skip("no CUDA card")


def as_many_cards(monkeypatch, root: str, cell: str) -> None:
    """The launcher sees as many cards as ``cell`` asks for; processes it
    starts see the cards there are."""
    import torch

    chips = int(registry.workload(registry.load_benchmark(root),
                                  cell)["chips"])
    if torch.cuda.device_count() < chips:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: chips)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_on_the_card(card, tiny_root, monkeypatch, cell):
    as_many_cards(monkeypatch, tiny_root, cell)
    out = run.run_cell(cell, 2**31 + 21, 0.5, True, root=tiny_root)
    assert out.get("forbidden", []) == []
    line = out["result"]
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert set(line["metrics"]) == CELLS[cell]
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
    assert line["breakdown"]["device_ops"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_on_the_card(card, tiny_root, monkeypatch, cell):
    as_many_cards(monkeypatch, tiny_root, cell)
    res = control.control(cell, 2**31 + 22, 0.5, root=tiny_root)
    assert res["correct"] is False
