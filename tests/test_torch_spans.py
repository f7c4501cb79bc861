"""The port's spans and counters (``utils/tracing.py``) on the CPU.

A profiled epoch holds every program span, the store step's four nested
in ``difacto.step`` in the order the step runs them; with no profiler
recording no range is made; the ``step`` counters equal the sums over the
prepped batches, streamed and replayed; a device-localized batch that
overflows its unique lanes is counted and warned about as the JAX
package's learner warns; ``LAUNCHES`` is the registry's ``launch`` group;
and :func:`tracing.span_times` reads a trace by span, on made-up events.
"""

import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import (build_sorted_slots, prep_batch,
                                         prep_batch_sharded)
from difacto_tpu_torch.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.ops import cuda
from difacto_tpu_torch.utils import tracing

torch.set_num_threads(2)

STORE_SPANS = ("difacto.pull", "difacto.loss", "difacto.keysum",
               "difacto.apply")
TRAIN_SPANS = ("difacto.epoch", "difacto.batch", "difacto.step",
               "difacto.place") + STORE_SPANS + ("difacto.epoch_end",)


@pytest.fixture
def data(tmp_path):
    path = tmp_path / "tr.svm"
    write_libsvm(make_ctr_data(600, num_fields=6, vocab_per_field=100,
                               seed=3), str(path))
    return path


def _cfg(path, *extra):
    return Config.from_kwargs([("data_in", str(path)), ("batch_size", "128"),
                               ("num_bits", "10"), ("max_nnz_per_row", "6"),
                               ("V_dim", "2"), *extra])


@pytest.fixture
def fresh(monkeypatch):
    """No trace taken yet in this process, no DIFACTO_PROFILE, counters at
    zero."""
    tracing.reset()
    tracing.reset_counters()
    monkeypatch.delenv("DIFACTO_PROFILE", raising=False)
    yield monkeypatch
    tracing.reset()


def test_profiled_epoch_holds_every_span_nested_in_order(fresh, tmp_path,
                                                         data):
    prof = tmp_path / "prof"
    fresh.setenv("DIFACTO_PROFILE", str(prof))
    SGDLearner(_cfg(data), device="cpu").train_epoch(0)
    trace = json.loads((prof / "train_epoch_0.pt.trace.json").read_text())
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("difacto.")]
    assert {e["name"] for e in spans} >= set(TRAIN_SPANS)
    steps = [e for e in spans if e["name"] == "difacto.step"]
    assert len(steps) == 5  # 600 rows, 128 a batch
    for st in steps:
        inner = sorted((e for e in spans
                        if e["tid"] == st["tid"] and e is not st
                        and st["ts"] <= e["ts"]
                        and e["ts"] + e["dur"] <= st["ts"] + st["dur"]),
                       key=lambda e: e["ts"])
        names = [e["name"] for e in inner if e["name"] in STORE_SPANS]
        assert names == list(STORE_SPANS)


def test_no_range_is_made_without_a_profiler(fresh, data):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was made with no profiler")

    fresh.setattr(tracing, "_Range", refuse)
    fresh.setattr(torch.profiler, "record_function", refuse)
    fresh.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tracing.span("difacto.x") is tracing.span("difacto.y")
    learner = SGDLearner(_cfg(data), device="cpu")
    learner.train_epoch(0)
    assert tracing.counters()["step.steps"] == 5


@pytest.mark.parametrize("extra", [
    (),                                       # pairs, sorted, packed
    (("segsum", "scatter"),),                 # the scatter backward
    (("kernel", "xla"),),                     # the stacked table
    (("hot_rows", "256"),),                   # the hot/cold split
    (("cache_on_device", "1"),),              # placed batches cached
])
def test_step_counters_are_the_prepped_batches_sums(fresh, data, extra):
    learner = SGDLearner(_cfg(data, ("cache_batches", "1"), *extra),
                         device="cpu")
    learner.train_epoch(0)
    after0 = tracing.counters()
    learner.train_epoch(1)
    c = tracing.delta({}, tracing.counters())
    (placed, batches), = learner._batch_cache.values()
    assert len(batches) == 5
    slots = sum(b.inv.shape[0] for b in batches)
    lanes = sum(b.uids.shape[0] for b in batches)
    real = sum(int(b.valid.sum()) for b in batches)
    assert [b.n_real for b in batches] == [int(b.valid.sum())
                                           for b in batches]
    assert c["step.steps"] == 10
    assert c["step.slots"] == 2 * slots == 2 * 600 * 6 + 2 * 40 * 6
    assert c["step.lanes"] == 2 * lanes
    assert c["step.unique_rows"] == 2 * real
    assert c["step.batches_streamed"] == after0["step.batches_streamed"] == 5
    assert c["step.batches_replayed"] == 5
    assert c["step.batch_wait_s"] > after0["step.batch_wait_s"] > 0
    # two epoch ends: seven metric leaves folded, two table counts read
    assert c["step.host_reads"] == 2 * (7 + 2)
    assert "step.ids_dropped" not in c


def test_device_localized_overflow_is_counted_and_warned(fresh, data,
                                                         caplog):
    learner = SGDLearner(_cfg(data, ("host_localize", "0"),
                              ("kernel", "xla"), ("unique_size", "64")),
                         device="cpu")
    store, folded = learner.store, []
    step = store.train_step

    def counted(*a, **k):
        state, m = step(*a, **k)
        folded.append(float(m.dropped_ids))
        return state, m

    store.train_step = counted
    with caplog.at_level(logging.WARNING, logger="difacto_tpu_torch"):
        learner.train_epoch(0)
    c = tracing.counters()
    assert sum(folded) > 0
    assert c["step.ids_dropped"] == int(sum(folded))
    assert any(r.getMessage() == "routing capacity overflow: %d ids dropped"
               % int(sum(folded)) for r in caplog.records)
    # lanes are the device's unique_size; no host count of distinct rows
    assert c["step.lanes"] == 5 * 64 and c["step.unique_rows"] == 0
    assert c["step.slots"] == 600 * 6 + 40 * 6


def test_launches_are_the_registrys_launch_group(fresh):
    assert tracing._GROUPS["launch"] is cuda.LAUNCHES
    before = tracing.counters()
    cuda.LAUNCHES["segsum_rows"] += 3
    assert tracing.delta(before) == {"launch.segsum_rows": 3}
    tracing.reset_counters()
    assert cuda.LAUNCHES["segsum_rows"] == 0
    assert tracing.format_counters({"step.lanes": 4, "step.batch_wait_s":
                                    0.5}) == ("step.batch_wait_s 0.5 "
                                              "step.lanes 4")


def _batch(seed, B=64, L=8, vocab=400):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, L)).astype(np.int32)
    ids[rng.random((B, L)) < 0.2] = -1
    return Batch(ids, np.ones((B, L), np.float32),
                 (rng.random(B) > 0.5).astype(np.float32),
                 np.ones(B, np.float32))


@pytest.mark.parametrize("how", ["local", "split", "sharded", "fixed"])
def test_n_real_is_the_real_lanes(how):
    b = _batch(1)
    if how == "local":
        pb = prep_batch(b, 1 << 10)
        assert pb.n_real == int(pb.valid.sum()) > 0
    elif how == "split":
        remap = np.random.default_rng(0).permutation(1 << 10)
        pb = prep_batch(b, 1 << 10, remap=remap.astype(np.int32),
                        hot_rows=128)
        assert pb.n_real == int(pb.valid.sum()) > 0
    else:
        pb = prep_batch_sharded(b, 1 << 10, 2,
                                fixed_ub=64 if how == "fixed" else None)
        real = pb.valid.reshape(2, pb.ub).sum(1)
        assert pb.n_real == tuple(int(r) for r in real)
        if how == "fixed":
            assert pb.dropped.sum() > 0


def _ev(name, t0, t1, *, id=0, device=False, thread=1, ann=False):
    return SimpleNamespace(
        name=name, id=id, thread=thread,
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        is_user_annotation=ann,
        time_range=SimpleNamespace(start=t0, end=t1))


def test_span_times_by_hand():
    """difacto.step [0, 100] holds difacto.pull [10, 30] and
    difacto.apply [60, 90]. The device runs: a gather an aten op inside
    pull launched, a hand kernel launched from apply through the driver
    API with no operator, a copy issued inside step outside pull and
    apply, a kernel launched by another thread, one whose runtime call
    the trace does not hold, and two device-side annotations, which are
    not operations (an aten op's id may equal a runtime call's: other
    counters). The device idles in [0, 15) and [50, 70) (open:
    difacto.step) and from its last operation to the end of the spans
    (open: difacto.apply)."""
    evs = [
        _ev("difacto.step", 0, 100, id=1),
        _ev("difacto.pull", 10, 30, id=2),
        _ev("aten::index_select", 12, 20, id=900),
        _ev("cudaLaunchKernel", 13, 14, id=900),
        _ev("difacto.apply", 60, 90, id=4),
        _ev("cuLaunchKernel", 62, 63, id=901),
        _ev("cudaMemcpyAsync", 40, 41, id=902),
        _ev("cudaLaunchKernel", 5, 6, id=903, thread=2),
        _ev("index_kernel", 20, 35, id=900, device=True),
        _ev("rowmajor_apply_kernel", 70, 85, id=901, device=True),
        _ev("Memcpy DtoD", 35, 50, id=902, device=True),
        _ev("other_thread_kernel", 15, 25, id=903, device=True),
        _ev("lost_kernel", 85, 88, id=904, device=True),
        _ev("fmbench.step", 0, 100, id=6, device=True, ann=True),
        _ev("difacto.apply", 60, 90, id=7, device=True),
    ]
    st = tracing.span_times(evs)
    assert st.by_span == pytest.approx({
        "difacto.pull": 15e-6, "difacto.apply": 15e-6,
        "difacto.step": 15e-6, tracing.OUTSIDE: 10e-6})
    assert st.unattributed_s == pytest.approx(3e-6)
    assert st.idle_by_span == pytest.approx({
        "difacto.step": 35e-6, "difacto.apply": 12e-6})
    assert tracing.span_times(evs[2:4]) == tracing.SpanTimes()
    # a window clips the operations and bounds the gaps
    st = tracing.span_times(evs, window=(30, 60))
    assert st.by_span == pytest.approx({"difacto.pull": 5e-6,
                                        "difacto.step": 15e-6})
    assert st.idle_by_span == pytest.approx({"difacto.step": 10e-6})


def test_to_host_counts_tensor_reads(fresh):
    out = tracing.to_host(torch.arange(3))
    assert out.tolist() == [0, 1, 2]
    assert tracing.to_host([1.0]).tolist() == [1.0]
    assert tracing.counters()["step.host_reads"] == 1


def test_sorted_slots_path_counts_one_step(fresh):
    """The store's own entry, as a caller that steps prepped batches
    without the learner (a benchmark's wrapper) drives it."""
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater

    cfg = Config.from_kwargs([("data_in", "x"), ("batch_size", "64"),
                              ("num_bits", "10"), ("max_nnz_per_row", "8"),
                              ("V_dim", "4")])
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    pb = prep_batch(_batch(2), store.num_rows)
    pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals)
    store.train_step_prepped(store.init_state(0), pb)
    c = tracing.delta({}, tracing.counters())
    assert c == {"step.steps": 1, "step.slots": 64 * 8,
                 "step.lanes": pb.uids.shape[0],
                 "step.unique_rows": pb.n_real}
