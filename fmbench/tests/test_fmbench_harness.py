"""The benchmark harness on the CPU, at a tiny size:

    python -m pytest fmbench/tests -q

Each test builds tiny cells in a temporary checkout: a copy of ``fmbench/``
with a configuration, a traffic mix and limits added as files and named in
a ``BENCHMARK.json`` of its own, which the harness finds with no edit. The
program runs its kernels' plain versions on the CPU. ``test_cell_on_card``
needs a CUDA card and skips without one.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
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
    for m in spec["per_layer"]:
        m["workloads"] = list(TINY)
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
        # no device on the CPU: only the host-clock metrics read
        assert set(out["metrics"]) == {"cache_fill_s.setup",
                                       "host_ms_per_step.train"}
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
        numbers = check.compare(dict(ref, **{key: bad}), ref)
        assert not all(check.judge(numbers, {"loss": 1, "grad": 1,
                                             "change": 1}).values())
    assert check.compare(ref, ref) == {"loss": 0.0, "grad": 0.0,
                                       "change": 0.0}


def test_counts_by_hand():
    """The yardstick's counts for one small batch, worked by hand: B = 2
    rows of L = 5 slots touching n = 10 rows, K = 4 (FM, payload 6 rows);
    FFM B = 2, L = 3, F = 3, k = 2 (K = 6), n = 5."""
    assert counts.pull_bytes(10, 4) == 4 * (10 + 20 + 40 + 50) == 480
    assert counts.apply_bytes(10, 4) == 4 * (10 + 30 + 40) + 8 * (
        40 + 80) == 1280
    assert counts.payload_rows("fm", 4) == 6
    assert counts.payload_rows("ffm", 6) == 7
    assert counts.segsum_bytes(10, 10, 6) == 4 * (60 + 10 + 60) == 520
    assert counts.step_bytes(2, 5, 10, 4, False) == 4 * (20 + 4 + 20) + (
        8 * 12 * 10) == 1136
    assert counts.step_bytes(2, 3, 5, 6, True) == 4 * (18 + 4 + 10) + (
        8 * 16 * 5) == 768
    assert counts.step_flops("fm", 2, 5, 10, 4, 0) == 400 + 44 + 470
    assert counts.step_flops("ffm", 2, 3, 5, 6, 3) == 144 + 48 + 20 + 315
    assert counts.least_time_s(3.35e12, 67e12 / 2) == (1.0, "bytes")
    assert counts.least_time_s(3.35e12 / 2, 67e12) == (1.0, "operations")


def _reader(name):
    return run.load_reader(REPO, name)


def test_trace_readers_by_hand():
    """kernel_roofline, step_mfu, launches, busy and idle shares on a
    made-up trace of one step of the FM batch above: its three kernels
    take twice their byte bound."""
    shape = dict(B=2, L=5, n=10, K=4, F=0, loss="fm", fields=False)
    kernel_bytes = 480 + 1280 + 520
    t_bound = kernel_bytes / counts.HBM_BYTES_PER_S
    summ = trace.Summary(
        window_s=4 * t_bound, busy_s=3 * t_bound,
        ops=[("void rowmajor_pull_kernel<4>(float const*)", 0.0, t_bound),
             ("segsum_tiles_kernel(float const*)", 0.0, t_bound / 2),
             ("segsum_cross(int const*)", 0.0, t_bound / 2),
             ("elementwise_kernel", 0.0, t_bound)],
        by_name={"void rowmajor_pull_kernel<4>(float const*)": t_bound / 2,
                 "segsum_tiles_kernel(float const*)": t_bound,
                 "segsum_cross(int const*)": t_bound / 2,
                 "void rowmajor_apply_kernel<4, false>(float*)": 2 * t_bound,
                 "elementwise_kernel": t_bound})
    step_s = counts.step_bytes(2, 5, 10, 4, False) / counts.HBM_BYTES_PER_S
    ctx = dict(trace=summ, traced_steps=1, shapes=[shape], counts=counts,
               device="cuda", host_ms=[1.0, 3.0], phases={"cache_fill": 2.5},
               window={"steps": 4, "wall_s": 4 * 5 * step_s})
    assert _reader("kernel_roofline.train")(ctx) == pytest.approx(25.0)
    assert _reader("step_mfu.train")(ctx) == pytest.approx(20.0)
    assert _reader("launches_per_step.train")(ctx) == 4
    assert _reader("device_busy_ms_per_step.train")(ctx) == pytest.approx(
        3 * t_bound * 1e3)
    assert _reader("device_idle_share.train")(ctx) == pytest.approx(25.0)
    assert _reader("host_ms_per_step.train")(ctx) == 2.0
    assert _reader("cache_fill_s.setup")(ctx) == 2.5
    empty = dict(ctx, trace=trace.Summary(), device="cpu")
    for name in ("kernel_roofline.train", "step_mfu.train",
                 "launches_per_step.train", "device_busy_ms_per_step.train",
                 "device_idle_share.train"):
        assert _reader(name)(empty) is None


def test_cell_on_card(root):
    """A tiny cell on the card through its kernels, and the reference on
    the card, agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    for cell in TINY:
        out, _ = run_tiny(root, cell, device="cuda")
        assert out["correct"], (cell, out["checks"])
