"""The diagnostics' bookkeeping on the CPU: the flag-order probe's plain
version at every cluster size, and the per-device, per-cluster-size record
behind ``require_flag_order`` (a pass at C covers every C' <= C).  K8 and
K9 themselves are held to their plain versions on the card in
``tests/test_torch_cuda.py``."""

import pytest

from schwarz_tpu_torch import diagnostics as dg
from schwarz_tpu_torch.exceptions import NotImplementedFeature


@pytest.fixture
def passed(monkeypatch):
    """A fresh record of passes, restored after the test."""
    record = {}
    monkeypatch.setattr(dg, "_FLAG_ORDER_PASSED", record)
    return record


@pytest.mark.parametrize("C", [None, 1, 3, 8])
def test_plain_probe_reports_the_cluster_and_no_sms(C):
    res = dg.flag_order_probe(1000, 20, "cpu", cluster=C)
    c = 1 if C is None else C
    assert res == {"mismatches": 0, "error": 0, "cluster": c,
                   "producer_sms": [-1] * c, "consumer_sms": [-1] * c}


@pytest.mark.parametrize("C", range(1, 9))
def test_a_pass_at_8_covers_every_smaller_cluster(passed, C):
    passed[0] = 8
    dg.require_flag_order("cuda:0", C)


@pytest.mark.parametrize("have,want", [(2, 4), (2, 3), (1, 8), (7, 8)])
def test_a_pass_at_a_smaller_cluster_does_not_cover(passed, have, want):
    passed[0] = have
    dg.require_flag_order("cuda:0", have)
    with pytest.raises(NotImplementedFeature, match="flag-order probe") as e:
        dg.require_flag_order("cuda:0", want)
    assert f"C >= {want} " in str(e.value)
    assert f"largest passed: {have})" in str(e.value)


def test_passes_are_per_device(passed):
    passed[1] = 8
    assert dg.flag_order_passed("cuda:1") == 8
    assert dg.flag_order_passed("cuda:0") == 0
    dg.require_flag_order("cuda:1", 8)
    with pytest.raises(NotImplementedFeature, match="cuda:0") as e:
        dg.require_flag_order("cuda:0")
    assert "largest passed: none" in str(e.value)


def test_the_plain_probe_records_nothing(passed):
    dg.flag_order_probe(100, 5, "cpu", cluster=8)
    assert passed == {}
