"""The benchmark harness on the CPU, at a tiny size:

    python -m pytest fmbench/tests -q

Each test builds tiny cells in a temporary checkout: a copy of ``fmbench/``
with a configuration, a traffic mix and limits added as files and named in
a ``BENCHMARK.json`` of its own, which the harness finds with no edit; one
cell's model is a module that exists only in that checkout. The program
runs its kernels' plain versions on the CPU. ``test_cell_on_card`` needs a
CUDA card and skips without one.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
HERE = REPO / "fmbench"
sys.path.insert(0, str(REPO))

from fmbench import check, control, counts, run, trace  # noqa: E402

TINY = {
    "fm_tiny.zipf": ("fm_criteo", "replay_large", "fm_criteo.replay_large",
                     dict(num_bits=12, max_nnz_per_row=8, V_dim=4),
                     dict(batch_size=64, nnz=8, batches=4, hash_bits=12)),
    "fm_tiny.flat": ("fm_criteo", "replay_flat", "fm_criteo.replay_flat",
                     dict(num_bits=12, max_nnz_per_row=8, V_dim=4),
                     dict(batch_size=64, nnz=8, batches=4)),
    "ffm_tiny.libffm": ("ffm_criteo", "replay_libffm", "ffm_criteo.replay",
                        dict(num_bits=10, max_nnz_per_row=5, num_fields=5,
                             V_dim=2),
                        dict(batch_size=32, nnz=5, batches=4,
                             vocab_per_field=50)),
}
SEED = 2 ** 31 + 12345
# a model that exists only in the test's checkout: FM, with the table's
# occurrence counts as one more checked leaf
MODEL_CELL = "fm_cnt_tiny.zipf"
MODEL_SOURCE = '''"""FM with the table's occurrence counts as one more leaf."""
import torch

from fmbench import reference as plain
from fmbench.models import fm
from fmbench.models.fm import (  # noqa: F401
    KERNELS, Model, shape, step_bytes, step_flops)

LEAVES = fm.LEAVES + ("cnt",)


def place(learner, seed, device, model):
    return fm.place(learner, seed, device, model)  # cnt = 0 with the rest


def keep(kept, state, metrics, call):
    fm.keep(kept, state, metrics, call)
    if call == plain.CHECKED_STEPS:
        kept["change_cnt"] = torch.linalg.vector_norm(state.cnt.double())


def reference(seed, first, model, device, dtype=torch.float64, fault=None):
    out = fm.reference(seed, first, model, device, dtype, fault)
    held, batches = plain.reference_batches(first, model.num_bits, device)
    cnt = torch.zeros(held.numel(), dtype=torch.float64, device=device)
    if fault != "frozen":
        for b in batches:
            flat = b.rows.reshape(-1)
            cnt.index_add_(0, flat, torch.ones_like(flat, dtype=cnt.dtype))
    out["change_cnt"] = float(torch.linalg.vector_norm(cnt))
    return out
'''

# the same model, with a reference that forgets the counts' change
LOST_CELL = "fm_cnt_lost_tiny.zipf"
LOST_SOURCE = MODEL_SOURCE + '''

_reference = reference


def reference(seed, first, model, device, dtype=torch.float64, fault=None):
    out = _reference(seed, first, model, device, dtype, fault)
    del out["change_cnt"]
    return out
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A checkout holding a copy of fmbench/ and tiny cells added as
    files: each a configuration, a traffic mix and limits (those of the
    full-size cell it shrinks)."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, r / "fmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for cell, (conf, traf, full, csize, tsize) in TINY.items():
        cname, tname = cell.split(".")[0], f"tiny_{cell.split('.')[1]}"
        c = json.loads((HERE / "configs" / f"{conf}.json").read_text())
        c["conf"].update(csize)
        (r / "fmbench" / "configs" / f"{cname}.json").write_text(
            json.dumps(c))
        t = json.loads((HERE / "traffic" / f"{traf}.json").read_text())
        t.update(tsize)
        if t["ids"] == "hashed_zipf":
            t["hash_bits"] = csize["num_bits"]
        (r / "fmbench" / "traffic" / f"{tname}.json").write_text(
            json.dumps(t))
        shutil.copy(HERE / "limits" / f"{full}.json",
                    r / "fmbench" / "limits" / f"{cell}.json")
        if cname not in [x["name"] for x in spec["configs"]]:
            spec["configs"].append({
                "name": cname, "source": "a test", "reduced": [],
                "file": f"fmbench/configs/{cname}.json", "why": "a test"})
        spec["workloads"].append({"name": cell, "config": cname,
                                  "traffic": tname, "chips": 1,
                                  "why": "a test"})
    # the model cell: the tiny FM's conf under a model of its own
    for cell, model, source in ((MODEL_CELL, "fm_cnt", MODEL_SOURCE),
                                (LOST_CELL, "fm_cnt_lost", LOST_SOURCE)):
        cname = cell.split(".")[0]
        c = json.loads((r / "fmbench" / "configs" / "fm_tiny.json")
                       .read_text())
        c.update(name=cname, model=model)
        (r / "fmbench" / "configs" / f"{cname}.json").write_text(
            json.dumps(c))
        (r / "fmbench" / "models" / f"{model}.py").write_text(source)
        shutil.copy(HERE / "limits" / "fm_criteo.replay_large.json",
                    r / "fmbench" / "limits" / f"{cell}.json")
        spec["configs"].append({"name": cname, "source": "a test",
                                "reduced": [], "why": "a test",
                                "file": f"fmbench/configs/{cname}.json"})
        spec["workloads"].append({"name": cell, "config": cname,
                                  "traffic": "tiny_zipf", "chips": 1,
                                  "why": "a test"})
    for m in spec["per_layer"]:
        m["workloads"] = list(TINY) + [MODEL_CELL]
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    return r


def run_tiny(root, cell, traced=False, seed=SEED, device="cpu"):
    out, phases = run.run_cell(root, cell, seed, 0.2, traced, device,
                               time.perf_counter())
    return out, phases


@pytest.mark.parametrize("cell", list(TINY))
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys_and_reference_agrees(root, cell, traced):
    """The result's five keys (the checks last), the metrics of the mode,
    and the port on the CPU agrees with the plain reference within the
    full-size cell's limits."""
    out, phases = run_tiny(root, cell, traced)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        # no device on the CPU: only the host clock's and the program
        # counters' metrics read
        assert set(out["metrics"]) == {"cache_fill_s.setup",
                                       "host_ms_per_step.train",
                                       "lane_fill.train",
                                       "batch_wait_s.setup"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"]
                                       for m in spec["end_to_end"]}
    assert set(phases) == {"interpreter", "import", "cuda_init", "kernels",
                           "inputs",
                           "state_init", "cache_fill", "warmup"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def test_same_seed_same_rows():
    t = json.loads((HERE / "traffic" / "replay_libffm.json").read_text())
    t.update(batch_size=16, batches=2, nnz=5)
    a = run.traffic.make_rows(t, 7, "cpu")
    b = run.traffic.make_rows(t, 7, "cpu")
    c = run.traffic.make_rows(t, 8, "cpu")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.labels, b.labels)
    assert torch.equal(a.fields, b.fields)
    assert not torch.equal(a.ids, c.ids)


def test_no_jax_loaded(root):
    """A run loads no module whose top-level name is jax, jaxlib, flax or
    difacto_tpu (difacto_tpu_torch is another name)."""
    code = (
        "import sys, time; from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from fmbench import run\n"
        f"run.run_cell(Path({str(root)!r}), 'ffm_tiny.libffm', 3, 0.1, True,"
        " 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    assert got.returncode == 0, got.stderr[-2000:]
    tops = set(eval(got.stdout.strip().splitlines()[-1]))
    assert "difacto_tpu_torch" in tops
    assert not tops & run.BANNED, tops & run.BANNED


def test_sources_read_no_jax_files():
    """No harness file imports JAX or the JAX package, or reads the JAX
    package's bench files."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|difacto_tpu)\b"
                     r"(?!_torch)", re.M)
    for p in HERE.rglob("*.py"):
        text = p.read_text()
        assert not pat.search(text), p
        for name in ("bench.py", "BENCH_r", "BENCH.md", "MULTICHIP"):
            assert name not in text or p.name == Path(__file__).name, (p,
                                                                       name)


def test_main_refuses_without_card(tmp_path):
    """No card: exit code 2, nothing on standard output; the same in a
    directory holding only BENCHMARK.json and fmbench/."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "fmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        got = subprocess.run(
            [sys.executable, "-m", "fmbench", "--workload",
             "fm_criteo.replay_large", "--seed", "5", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=cwd)
        assert got.returncode != 0 and got.stdout == "", got


def _frozen(orig):
    def step(self, state, pb):
        metrics, _ = self.eval_step_prepped(state, pb)
        return state, metrics
    return step


def _half_batch(orig):
    def step(self, state, pb):
        m = pb.mask.clone()
        B = m.shape[0]
        m[B // 2:] = 0.0
        m[:B // 2] *= 2.0
        return orig(self, state, dataclasses.replace(pb, mask=m))
    return step


def _loss_altered(orig):
    def step(self, state, pb):
        st, metrics = orig(self, state, pb)
        return st, metrics._replace(logloss_sum=metrics.logloss_sum * 1.001)
    return step


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _loss_altered])
@pytest.mark.parametrize("cell", ["fm_tiny.zipf", "ffm_tiny.libffm"])
def test_broken_step_is_not_correct(root, monkeypatch, cell, fault):
    """The timed path broken underneath: a step that leaves the table as
    it was; half of each batch left out and the mean taken over the rest;
    a step's loss altered where it is produced. Each run reads
    ``correct`` false."""
    from difacto_tpu_torch.parallel.store import LocalStore

    monkeypatch.setattr(LocalStore, "train_step_prepped",
                        fault(LocalStore.train_step_prepped))
    out, _ = run_tiny(root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", list(TINY))
def test_control_is_not_correct(root, cell):
    """The reference in the program's place in bfloat16 fails a limit;
    so do its planted faults."""
    got = control.readings(root, cell, 11, torch.device("cpu"))
    limits = json.loads((root / "fmbench" / "limits" /
                         f"{cell}.json").read_text())["limits"]
    for name, numbers in got.items():
        assert not all(check.judge(numbers, limits).values()), (name,
                                                                numbers)


def test_nan_reading_is_not_correct():
    """A reading that is not a number fails its limit."""
    ref = {"loss": [1.0, 2.0, 3.0], "grad_w": 1.0, "grad_V": 2.0,
           "change_w": 1.0, "change_V": 2.0}
    nan = float("nan")
    for key, bad in (("loss", [1.0, nan, 3.0]), ("grad_V", nan),
                     ("change_w", nan)):
        numbers = check.compare(dict(ref, **{key: bad}), ref, ("w", "V"))
        assert not all(check.judge(numbers, {"loss": 1, "grad": 1,
                                             "change": 1}).values())
    assert check.compare(ref, ref, ("w", "V")) == {"loss": 0.0, "grad": 0.0,
                                                   "change": 0.0}
    # a reading the program does not give is not a number
    lost = {k: v for k, v in ref.items() if k != "change_V"}
    assert check.compare(lost, ref, ("w", "V"))["change"] == float("inf")
    # a leaf with no gradient is left out of grad; a leaf whose change the
    # reference does not give stops the comparison
    assert check.compare(dict(ref, change_cnt=3.0),
                         dict(ref, change_cnt=3.0),
                         ("w", "V", "cnt"))["grad"] == 0.0
    with pytest.raises(KeyError, match="change_cnt"):
        check.compare(dict(ref, change_cnt=3.0), ref, ("w", "V", "cnt"))


def _model(loss):
    return run.load_model(REPO, {"conf": {"loss": loss}})


FM_SHAPE = dict(B=2, L=5, n=10, K=4)
FFM_SHAPE = dict(B=2, L=3, n=5, K=6, F=3, fields=True)


def test_counts_by_hand():
    """The yardstick's counts for one small batch, worked by hand: B = 2
    rows of L = 5 slots touching n = 10 rows, K = 4 (FM); FFM B = 2,
    L = 3, F = 3, k = 2 (K = 6), n = 5 (payload 7 rows)."""
    fm, ffm = _model("fm"), _model("ffm")
    assert counts.pull_bytes(10, 4) == 4 * (10 + 20 + 40 + 50) == 480
    assert counts.apply_bytes(10, 4) == 4 * (10 + 30 + 40) + 8 * (
        40 + 80) == 1280
    assert counts.segsum_bytes(10, 10, 6) == 4 * (60 + 10 + 60) == 520
    # the fused sums: 3 words a slot, d and S of each row, the touched
    # rows' K factors, 1 + K sums a row
    assert counts.fm_keysum_bytes(10, 2, 10, 4) == 4 * (
        30 + 10 + 40 + 50) == 520
    assert counts.fm_keysum_bytes(12, 3, 7, 2) == 4 * (
        36 + 9 + 14 + 21) == 320
    assert fm.step_bytes(FM_SHAPE) == counts.step_bytes(
        2, 5, 10, 4, False) == 4 * (20 + 4 + 20) + 8 * 12 * 10 == 1136
    assert ffm.step_bytes(FFM_SHAPE) == counts.step_bytes(
        2, 3, 5, 6, True) == 4 * (18 + 4 + 10) + 8 * 16 * 5 == 768
    assert counts.update_flops(10, 4) == 470
    assert fm.step_flops(FM_SHAPE) == 400 + 44 + 470
    assert ffm.step_flops(FFM_SHAPE) == 144 + 48 + 20 + 315
    assert {k: b(FM_SHAPE) for k, (_, b) in fm.KERNELS.items()} == {
        "pull": 480, "segsum": 520, "apply": 1280}
    assert {k: b(FFM_SHAPE) for k, (_, b) in ffm.KERNELS.items()} == {
        "pull": 4 * 5 * 16, "segsum": 4 * (7 * 6 + 6 + 7 * 5),
        "apply": 4 * (5 + 15 + 30) + 8 * (20 + 60)}
    assert counts.least_time_s(3.35e12, 67e12 / 2) == (1.0, "bytes")
    assert counts.least_time_s(3.35e12 / 2, 67e12) == (1.0, "operations")


def _reader(name):
    return run.load_reader(REPO, name)


def test_trace_readers_by_hand():
    """Every reader on a made-up trace of one step of the FM batch above:
    its three kernels (B1, the fused per-key sums, B2) take twice their
    byte bound; the FFM batch's (B1, B3, B2) three times theirs, beside an
    FM kernel FFM does not count; the program's spans and counters."""
    fm, ffm = _model("fm"), _model("ffm")
    kernel_bytes = 480 + 520 + 1280
    t_bound = kernel_bytes / counts.HBM_BYTES_PER_S
    summ = trace.Summary(
        window_s=4 * t_bound, busy_s=3 * t_bound,
        ops=[("void rowmajor_pull_kernel<4>(float const*)", 0.0, t_bound),
             ("fm_keysum_kernel(float const*)", 0.0, t_bound / 2),
             ("void fm_keysum_join<false>(int const*)", 0.0, t_bound / 2),
             ("elementwise_kernel", 0.0, t_bound)],
        by_name={"void rowmajor_pull_kernel<4>(float const*)": t_bound / 2,
                 "fm_keysum_kernel(float const*)": t_bound,
                 "void fm_keysum_join<false>(int const*)": t_bound / 2,
                 "void rowmajor_apply_kernel<4, false>(float*)": 2 * t_bound,
                 "elementwise_kernel": t_bound},
        spans=trace.Spans(
            by_span={"difacto.pull": 2e-3, "difacto.loss": 6e-3,
                     "difacto.keysum": 4e-3, "difacto.apply": 3e-3,
                     "difacto.step": 1e-3},
            idle_by_span={"difacto.epoch_end": 5e-4, "difacto.step": 5e-3}))
    step_s = counts.step_bytes(2, 5, 10, 4, False) / counts.HBM_BYTES_PER_S
    ctx = dict(trace=summ, spans=summ.spans, traced_steps=1,
               shapes=[FM_SHAPE], counts=counts, model=fm, device="cuda",
               host_ms=[1.0, 3.0], phases={"cache_fill": 2.5},
               window={"steps": 4, "wall_s": 4 * 5 * step_s},
               counters={"setup": {"step.batch_wait_s": 1.25},
                         "train": {"step.lanes": 400,
                                   "step.unique_rows": 300,
                                   "launch.pull_rowmajor": 2}})
    assert _reader("kernel_roofline.train")(ctx) == pytest.approx(25.0)
    assert _reader("step_mfu.train")(ctx) == pytest.approx(20.0)
    assert _reader("launches_per_step.train")(ctx) == 4
    assert _reader("device_busy_ms_per_step.train")(ctx) == pytest.approx(
        3 * t_bound * 1e3)
    assert _reader("device_idle_share.train")(ctx) == pytest.approx(25.0)
    assert _reader("host_ms_per_step.train")(ctx) == 2.0
    assert _reader("cache_fill_s.setup")(ctx) == 2.5
    assert _reader("pull_ms_per_step.train")(ctx) == pytest.approx(2.0)
    assert _reader("loss_ms_per_step.train")(ctx) == pytest.approx(6.0)
    assert _reader("keysum_ms_per_step.train")(ctx) == pytest.approx(4.0)
    assert _reader("apply_ms_per_step.train")(ctx) == pytest.approx(3.0)
    assert _reader("epoch_end_idle_ms_per_step.train")(ctx) == (
        pytest.approx(0.5))
    assert _reader("lane_fill.train")(ctx) == pytest.approx(75.0)
    assert _reader("batch_wait_s.setup")(ctx) == 1.25
    # FFM: B1, B3 and B2 at three times their bound; the fused sums'
    # kernel is not FFM's and counts neither bytes nor time
    ffm_bytes = 320 + 332 + 840
    tb = ffm_bytes / counts.HBM_BYTES_PER_S
    ffm_trace = trace.Summary(by_name={
        "void rowmajor_pull_kernel<4>(float const*)": tb,
        "segsum_tiles_kernel(float const*)": tb / 2,
        "void segsum_cross<false>(int const*)": tb / 2,
        "void rowmajor_apply_kernel<4, false>(float*)": tb,
        "fm_keysum_kernel(float const*)": 5 * tb})
    assert _reader("kernel_roofline.train")(dict(
        ctx, trace=ffm_trace, model=ffm, shapes=[FFM_SHAPE])) == (
        pytest.approx(100.0 / 3))
    empty = dict(ctx, trace=trace.Summary(), spans=None, device="cpu",
                 counters={"setup": None, "train": None})
    for name in ("kernel_roofline.train", "step_mfu.train",
                 "launches_per_step.train", "device_busy_ms_per_step.train",
                 "device_idle_share.train", "pull_ms_per_step.train",
                 "loss_ms_per_step.train", "keysum_ms_per_step.train",
                 "apply_ms_per_step.train",
                 "epoch_end_idle_ms_per_step.train", "lane_fill.train",
                 "batch_wait_s.setup"):
        assert _reader(name)(empty) is None, name
    # spans without a device operation (the CPU): the span readers read
    # nothing; a batch localized on the device counts no distinct rows
    cpu = dict(ctx, spans=trace.Spans(idle_by_span={"difacto.epoch_end": 1.0}),
               counters={"setup": {}, "train": {"step.lanes": 400}})
    for name in ("pull_ms_per_step.train", "loss_ms_per_step.train",
                 "keysum_ms_per_step.train", "apply_ms_per_step.train",
                 "epoch_end_idle_ms_per_step.train", "lane_fill.train",
                 "batch_wait_s.setup"):
        assert _reader(name)(cpu) is None, name


@dataclasses.dataclass
class _Event:
    """A profiler event as fmbench/trace.py reads one (times in µs)."""

    name: str
    start: float
    end: float
    thread: int = 1
    device: bool = False
    id: int = 0

    @property
    def time_range(self):
        return types.SimpleNamespace(start=self.start, end=self.end)

    @property
    def device_type(self):
        return "DeviceType.CUDA" if self.device else "DeviceType.CPU"


def test_spans_by_hand():
    """The window read by the program's spans: each device operation goes
    to the innermost span open when its runtime call started, on the
    harness's thread (a launch from another thread goes outside every
    span, an operation without a call is unlinked); each idle gap to the
    span open at its start."""
    host = [("fmbench.window", 0, 100), ("difacto.step", 10, 70),
            ("difacto.pull", 10, 20), ("difacto.loss", 20, 48),
            ("difacto.epoch_end", 70, 100)]
    evs = [_Event(n, a, b) for n, a, b in host]
    evs += [_Event("cudaLaunchKernel", t, t + 1, id=i)
            for i, t in ((1, 12), (2, 25), (3, 55))]
    evs += [_Event("cudaLaunchKernel", 30, 31, thread=2, id=4)]
    evs += [_Event(n, a, b, device=True, id=i) for n, a, b, i in (
        ("pull_kernel", 15, 25, 1), ("loss_kernel", 30, 50, 2),
        ("step_kernel", 60, 65, 3), ("other_thread", 66, 70, 4),
        ("no_call", 70, 72, 99), ("fmbench.step", 10, 70, 0))]
    summ = trace.summarize(types.SimpleNamespace(events=lambda: evs))
    assert summ.window_s == pytest.approx(100e-6)
    assert summ.busy_s == pytest.approx(41e-6)
    sp = summ.spans
    want = {"difacto.pull": 10, "difacto.loss": 20, "difacto.step": 5,
            trace.OUTSIDE: 4}
    assert sp.by_span == pytest.approx({k: v * 1e-6
                                        for k, v in want.items()})
    want = {trace.OUTSIDE: 15, "difacto.loss": 5, "difacto.step": 11,
            "difacto.epoch_end": 28}
    assert sp.idle_by_span == pytest.approx({k: v * 1e-6
                                             for k, v in want.items()})
    assert sp.unlinked_s == pytest.approx(2e-6)
    # the readers over it, one traced step
    ctx = dict(spans=sp, traced_steps=1)
    assert _reader("pull_ms_per_step.train")(ctx) == pytest.approx(0.010)
    assert _reader("loss_ms_per_step.train")(ctx) == pytest.approx(0.020)
    assert _reader("keysum_ms_per_step.train")(ctx) is None
    assert _reader("epoch_end_idle_ms_per_step.train")(ctx) == (
        pytest.approx(0.028))
    # no window span: no reading by span
    assert trace.summarize(types.SimpleNamespace(
        events=lambda: evs[1:])).spans is None


def test_model_added_as_a_file(root):
    """A configuration whose model is a module that only the checkout
    holds runs end to end with ``correct`` true, its extra leaf compared;
    every file the harness had is as it was."""
    for f in (root / "fmbench").rglob("*"):
        mine = HERE / f.relative_to(root / "fmbench")
        if f.is_file() and mine.is_file() and "__pycache__" not in f.parts:
            assert f.read_bytes() == mine.read_bytes(), f
    assert not (HERE / "models" / "fm_cnt.py").exists()
    cell = run.load_cell(root, MODEL_CELL)
    assert run.load_model(root, cell.config).LEAVES == ("w", "V", "cnt")
    out, _ = run_tiny(root, MODEL_CELL)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss", "grad", "change"}


def test_model_leaf_fault_is_not_correct(root, monkeypatch):
    """One occurrence count changed where the model's ``keep`` reads it:
    the loss and the gradients are the program's own, the change reads
    the fault."""
    from difacto_tpu_torch.parallel.store import LocalStore

    orig = LocalStore.train_step_prepped
    calls = []

    def step(self, state, pb):
        st, metrics = orig(self, state, pb)
        calls.append(1)
        if len(calls) == run.CHECKED_STEPS:
            st.cnt[int(st.cnt.argmax())] += 1.0
        return st, metrics

    monkeypatch.setattr(LocalStore, "train_step_prepped", step)
    out, _ = run_tiny(root, MODEL_CELL)
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["loss"]["value"] <= checks["loss"]["limit"]
    assert checks["grad"]["value"] <= checks["grad"]["limit"]
    assert checks["change"]["value"] > checks["change"]["limit"]


def test_model_reference_without_a_change_stops_the_run(root):
    """A model whose reference gives no change for one of its ``LEAVES``
    (the counts) fails the run: the leaf is not left out of ``correct``."""
    with pytest.raises(KeyError, match="change_cnt"):
        run_tiny(root, LOST_CELL)


def test_model_without_module_stops_the_run(root):
    with pytest.raises(SystemExit, match="no module fmbench/models/deepfm"):
        run.load_model(root, {"name": "x", "model": "deepfm", "conf": {}})


def test_cell_on_card(root):
    """A tiny cell on the card through its kernels, and the reference on
    the card, agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    for cell in TINY:
        out, _ = run_tiny(root, cell, device="cuda")
        assert out["correct"], (cell, out["checks"])
