"""The port's utilities against the JAX package's: the stage timer, the
three CSV writers (byte-equal files from the same numpy inputs), the
validation helpers, and the port's executor selection."""

import numpy as np
import pytest
import torch

import schwarz_tpu.models as jmodels
import schwarz_tpu.utils as jutils
import schwarz_tpu.utils.validation as jval
import schwarz_tpu_torch.models as tmodels
import schwarz_tpu_torch.utils as tutils
import schwarz_tpu_torch.utils.validation as tval
from schwarz_tpu_torch.exceptions import SchwarzError
from schwarz_tpu_torch.utils.backend import ExecutorError, ensure_backend


def test_stages_equal_jax():
    assert tutils.STAGES == jutils.STAGES


def test_stage_timer_summary():
    t = tutils.StageTimer()
    for _ in range(3):
        with t.time("local_solve"):
            pass
    t.start("boundary_exchange")
    t.stop()
    s = t.summary()
    assert set(s) == {"local_solve", "boundary_exchange"}
    v = s["local_solve"]
    assert v["count"] == 3 and s["boundary_exchange"]["count"] == 1
    assert v["min"] <= v["med"] <= v["max"] <= v["total"]
    assert v["avg"] == pytest.approx(v["total"] / 3)
    # the summary's statistics are the JAX timer's on the same samples
    j = jutils.StageTimer()
    j.samples.update({k: list(x) for k, x in t.samples.items()})
    assert j.summary() == s


def _summary(rng):
    t = tutils.StageTimer()
    for stage in ("boundary_exchange", "local_solve", "coarse_correction"):
        t.samples[stage] = list(rng.uniform(1e-5, 1e-2, size=7))
    return t.summary()


def test_write_timings_byte_equal(tmp_path, rng):
    summary = _summary(rng)
    jutils.write_timings(summary, str(tmp_path / "j.csv"))
    tutils.write_timings(summary, str(tmp_path / "t.csv"))
    t = (tmp_path / "t.csv").read_bytes()
    assert t == (tmp_path / "j.csv").read_bytes()
    assert t.splitlines()[0] == b"func,total,avg,min,med,max"


@pytest.mark.parametrize("locality", [None, "all", "mixed"])
def test_write_comm_data_byte_equal(tmp_path, rng, locality):
    S = 6
    cm = rng.integers(0, 40, size=(S, S)) * (rng.random((S, S)) < 0.4)
    loc = {None: None, "all": np.ones((S, S), bool),
           "mixed": rng.random((S, S)) < 0.5}[locality]
    jutils.write_comm_data(cm, 17, str(tmp_path / "j.csv"), locality=loc)
    tutils.write_comm_data(cm, 17, str(tmp_path / "t.csv"), locality=loc)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_write_iters_and_residuals_byte_equal(tmp_path, rng):
    it, S = 9, 3
    lh = rng.random((it, S)) * 10.0 ** -rng.integers(0, 12, size=(it, S))
    gh = rng.random(it)
    ih = rng.integers(0, 50, size=(it, S)).astype(np.int32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jutils.write_iters_and_residuals(lh, gh, ih, str(tmp_path / "j") + "/")
    tutils.write_iters_and_residuals(lh, gh, ih, str(tmp_path / "t") + "/")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == [f"iter_res_{p:02d}.csv" for p in range(S)]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


@pytest.mark.parametrize("perm", [[2, 0, 1], [0, 0, 1], [0, 1, 3], [-1, 0, 1],
                                  list(range(10))[::-1]])
def test_validate_permutation_equal_jax(perm):
    p = np.asarray(perm)
    assert tval.validate_permutation(p) == jval.validate_permutation(p)


def test_find_duplicates_and_dump_equal_jax(tmp_path):
    arr = np.array([1, 2, 2, 3, 2])
    assert tval.find_duplicates(arr, 2) == jval.find_duplicates(arr, 2) == 3
    assert tutils.find_duplicates is tval.find_duplicates
    assert tutils.validate_permutation is tval.validate_permutation
    A = tmodels.laplacian_2d(5)
    tval.dump_csr_csv(A, str(tmp_path / "t.csv"))
    jval.dump_csr_csv(jmodels.laplacian_2d(5), str(tmp_path / "j.csv"))
    t = (tmp_path / "t.csv").read_bytes()
    assert t == (tmp_path / "j.csv").read_bytes()
    assert len(t.splitlines()) == A.nnz + 1


def test_ensure_backend_cpu():
    assert ensure_backend("cpu") == "cpu"


@pytest.mark.parametrize("name", ["tpu", "omp", "reference", "gpu", ""])
def test_ensure_backend_unknown_raises(name):
    with pytest.raises(ExecutorError, match="unknown executor"):
        ensure_backend(name)


@pytest.mark.parametrize("name", ["auto", "cuda"])
def test_ensure_backend_without_gpu_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutorError, match="--executor cpu"):
        ensure_backend(name)
    assert issubclass(ExecutorError, SchwarzError)


@pytest.mark.parametrize("name", ["auto", "cuda"])
def test_ensure_backend_with_gpu_selects_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ensure_backend(name) == "cuda"
