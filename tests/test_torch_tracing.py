"""The port's tracing hooks (``utils/tracing.py``) on the CPU.

``DIFACTO_PROFILE=<dir>`` writes one ``torch.profiler`` Chrome trace of
the first profiled region and none of any later one; without the
variable nothing is written. ``SGDLearner.train_epoch`` is a region, as
in the JAX package. ``StepTimer.summary`` as the JAX package's.
"""

import json

import pytest
import torch

from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.utils import tracing as jtracing
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.utils import tracing

torch.set_num_threads(2)


@pytest.fixture
def fresh(monkeypatch):
    """A process whose first region has not been taken yet."""
    tracing.reset()
    monkeypatch.delenv("DIFACTO_PROFILE", raising=False)
    yield monkeypatch
    tracing.reset()


def _work():
    x = torch.arange(64, dtype=torch.float32)
    return float(torch.sigmoid(x).sum())


def test_no_trace_without_the_variable(fresh, tmp_path):
    with tracing.profile_region("r"):
        _work()
    assert list(tmp_path.iterdir()) == []
    # an untraced region does not take the first trace
    fresh.setenv("DIFACTO_PROFILE", str(tmp_path / "prof"))
    with tracing.profile_region("later"):
        _work()
    assert [p.name for p in (tmp_path / "prof").iterdir()] == [
        "later.pt.trace.json"]


def test_first_region_wins(fresh, tmp_path):
    prof = tmp_path / "prof"
    fresh.setenv("DIFACTO_PROFILE", str(prof))
    with tracing.profile_region("first"):
        _work()
    with tracing.profile_region("second"):
        _work()
    files = sorted(p.name for p in prof.iterdir())
    assert files == ["first.pt.trace.json"]
    trace = json.loads((prof / files[0]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::sigmoid" in names


def test_train_epoch_is_the_traced_region(fresh, tmp_path):
    write_libsvm(make_ctr_data(600, num_fields=6, vocab_per_field=100,
                               seed=3), str(tmp_path / "tr.svm"))
    prof = tmp_path / "prof"
    fresh.setenv("DIFACTO_PROFILE", str(prof))
    cfg = Config.from_kwargs([("data_in", str(tmp_path / "tr.svm")),
                              ("batch_size", "128"), ("num_bits", "10"),
                              ("max_nnz_per_row", "6"), ("V_dim", "2"),
                              ("max_num_epochs", "2")])
    SGDLearner(cfg, device="cpu").run()
    assert sorted(p.name for p in prof.iterdir()) == [
        "train_epoch_0.pt.trace.json"]
    trace = json.loads((prof / "train_epoch_0.pt.trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])


@pytest.mark.parametrize("value,on", [("", False), ("0", False), ("1", True),
                                      ("yes", True)])
def test_verbose_reads_the_variable_as_jax_does(monkeypatch, value, on):
    monkeypatch.setenv("DIFACTO_VERBOSE", value)
    assert tracing.verbose() is jtracing.verbose() is on


def test_step_timer_summary_as_jax():
    mine, theirs = tracing.StepTimer(), jtracing.StepTimer()
    assert mine.summary() == theirs.summary() == "no steps timed"
    times = [0.004, 0.001, 0.003, 0.002, 0.010]
    mine.times, theirs.times = list(times), list(times)
    assert mine.summary() == theirs.summary()
    assert mine.summary().startswith("5 steps: p50 3.0ms p90 10.0ms")
    mine.stop()  # a stop without a start times nothing
    mine.start()
    _work()
    mine.stop()
    assert len(mine.times) == 6 and mine.times[-1] >= 0.0
