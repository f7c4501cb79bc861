"""One run of one benchmark cell.

    python -m fmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration (its
file under ``fmbench/configs/``) and a traffic mix
(``fmbench/traffic/<name>.json``); its correctness limits are
``fmbench/limits/<cell>.json``, and each per-layer metric is read by
``fmbench/metrics/<metric>.py``. Nothing here names a cell.

Set-up builds one ``SGDLearner`` of ``difacto_tpu_torch`` on the card
(``cache_batches=1 cache_on_device=1``), writes the benchmark's own initial
table into it, and trains epoch 0, which streams the traffic's rows
(written to ``memory://`` in the configuration's data format) through the
learner's host prep into its device batch cache; the first three steps are
kept for the correctness check. Epoch 1 warms up, on the same batches.
The window then runs ``train_epoch(e)`` for e = 2, 3, ... over the cache,
as epochs past the first of ``python -m difacto_tpu_torch <conf>`` do, and
stops at the first epoch boundary after ``--seconds``.

``--trace 1`` runs the same window with the host's enqueue of each step
timed, then a fixed number of epochs under ``torch.profiler``, and prints
the per-layer metrics. Once the window has closed and the program's state
is freed, the plain reference (fmbench/reference.py) trains the same
first three steps and fmbench/check.py compares them.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, counts, reference, trace, traffic

DIR = "fmbench"
# the names whose presence in sys.modules fails a run: the JAX package and
# JAX itself must not be what is measured
BANNED = frozenset({"jax", "jaxlib", "flax", "difacto_tpu"})
# steps traced by torch.profiler with --trace 1 (whole epochs, at least)
TRACED_STEPS = 192
CHECKED_STEPS = 3
# the calls of each epoch whose host time counts as the enqueue: an epoch
# begins after the learner's epoch-end sync, so these never wait on a full
# queue of launches (about a thousand; a step launches about a hundred)
ENQUEUE_STEPS = 4
MEMORY_ROOT = "memory://fmbench"


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from /proc; the
    call's own time where /proc is missing)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, workload: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    ce = next(c for c in spec["configs"] if c["name"] == wl["config"])
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    data = root / DIR
    return Cell(
        name=workload, chips=wl["chips"],
        config=json.loads((root / ce["file"]).read_text()),
        traffic=json.loads((data / "traffic" / f"{wl['traffic']}.json")
                           .read_text()),
        limits=json.loads((data / "limits" / f"{workload}.json")
                          .read_text())["limits"],
        end_to_end=e2e, per_layer=per_layer)


def build_config(cell: Cell, data_in: str):
    from difacto_tpu_torch.config import Config

    kw = [(k, str(v)) for k, v in cell.config["conf"].items()]
    kw += [("batch_size", str(cell.traffic["batch_size"])),
           ("data_in", data_in)]
    return Config.from_kwargs(kw)


def initial_factors(seed: int, rows: int, k: int, scale: float,
                    device) -> torch.Tensor:
    """The benchmark's initial V [rows, k], uniform in (-scale, scale),
    from its own generator (one the traffic does not draw from)."""
    g = traffic.generator(seed ^ 0x5DEECE66D, device)
    v = torch.rand((rows, k), generator=g, device=device)
    return v.mul_(2.0).sub_(1.0).mul_(scale)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Hooks:
    """Wraps the store's step entry (``train_step_prepped``), the one call
    the learner makes a step. It counts the calls; during the first
    ``CHECKED_STEPS`` of epoch 0 it keeps what the correctness check reads
    (each step's loss, the optimizer state's norms); in the window it
    stamps each step's start (a CUDA event on the stream, or the host
    clock on the CPU) and, when asked, times the host's enqueue of the
    first ``ENQUEUE_STEPS`` calls of each epoch and marks each step for the
    profiler."""

    def __init__(self, store, V0: torch.Tensor):
        self.orig = store.train_step_prepped
        store.train_step_prepped = self.step
        self.calls = 0
        self.V0 = V0
        self.readings: dict = {"loss": []}
        self.stamps: list | None = None
        self.host_ms: list | None = None
        self.span = False
        self.in_epoch = 0
        self.cuda = store.device.type == "cuda"

    def stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def step(self, state, pb):
        if self.stamps is not None:
            self.stamps.append(self.stamp())
        self.in_epoch += 1
        t0 = time.perf_counter()
        if self.span:
            with torch.profiler.record_function("fmbench.step"):
                out = self.orig(state, pb)
        else:
            out = self.orig(state, pb)
        if self.host_ms is not None and self.in_epoch <= ENQUEUE_STEPS:
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
        self.calls += 1
        if self.calls <= CHECKED_STEPS:
            self.keep(out[0], out[1])
        return out

    def keep(self, state, metrics) -> None:
        """Readings of the program's first steps, as device tensors."""
        r = self.readings
        r["loss"].append(metrics.logloss_sum.double())
        if self.calls == 1:
            r["grad_w"] = state.n.double().sum().sqrt()
        if self.calls == 2:
            r["grad_V"] = state.nV.double().sum().sqrt()
        if self.calls == CHECKED_STEPS:
            r["change_w"] = torch.linalg.vector_norm(state.w.double())
            acc = torch.zeros((), dtype=torch.float64, device=state.w.device)
            V, V0 = state.V, self.V0
            for lo in range(0, V0.shape[0], 1 << 18):
                d = (V[:, lo:lo + (1 << 18)].double()
                     - V0[lo:lo + (1 << 18)].T.double())
                acc += (d * d).sum()
            r["change_V"] = acc.sqrt()
            self.V0 = None

    def take_readings(self) -> dict:
        r = self.readings
        return {"loss": [float(x) for x in r["loss"]],
                **{k: float(v) for k, v in r.items() if k != "loss"}}


def step_ms(hooks: Hooks, end) -> list[float]:
    s = hooks.stamps + [end]
    if hooks.cuda:
        return [a.elapsed_time(b) for a, b in zip(s, s[1:])]
    return [(b - a) * 1e3 for a, b in zip(s, s[1:])]


def run_window(learner, hooks: Hooks, epoch: int, seconds: float,
               device) -> dict:
    """Epochs from ``epoch`` until the first boundary past ``seconds``."""
    hooks.stamps = []
    calls0 = hooks.calls
    sync(device)
    t0 = time.perf_counter()
    examples = 0.0
    while True:
        hooks.in_epoch = 0
        examples += learner.train_epoch(epoch).num_examples
        epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    end = hooks.stamp()
    sync(device)
    wall = time.perf_counter() - t0
    ms = step_ms(hooks, end)
    hooks.stamps = None
    return {"t0": t0, "wall_s": wall, "examples": examples,
            "steps": hooks.calls - calls0, "step_ms": ms, "epoch": epoch}


def run_traced(learner, hooks: Hooks, epoch: int, epochs: int,
               device) -> trace.Summary:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    hooks.span = True
    with profile(activities=acts) as prof:
        with record_function("fmbench.window"):
            sync(device)
            for e in range(epoch, epoch + epochs):
                with record_function("fmbench.epoch"):
                    learner.train_epoch(e)
            sync(device)
    hooks.span = False
    return trace.summarize(prof)


def load_reader(root: Path, name: str):
    path = root / DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fmbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def batch_counts(rows: traffic.Rows, m: reference.Model) -> list[dict]:
    """Each replayed batch's shape for the yardstick's counts."""
    B, L = rows.batch_size, rows.ids.shape[1]
    return [dict(B=B, L=L, n=n, K=m.K, F=m.F, loss=m.loss,
                 fields=rows.fields is not None)
            for n in traffic.distinct_rows(rows, m.num_bits)]


def reference_batches(first: traffic.Rows, num_bits: int, device):
    """The first batches for the reference, and the table rows they hold
    (ids hashed on the host as the configuration's ``num_bits`` says)."""
    raw = first.ids.cpu().numpy().astype(np.uint64)
    held, idx = torch.unique(torch.as_tensor(
        reference.hash_rows(raw, num_bits), device=device),
        return_inverse=True)
    out = []
    for i in range(first.num_batches):
        s = slice(i * first.batch_size, (i + 1) * first.batch_size)
        out.append(reference.Batch(
            rows=idx[s], labels=first.labels[s].to(device),
            fields=(None if first.fields is None
                    else first.fields[s].to(device).long())))
    return held, out


def reference_readings(seed: int, m: reference.Model, first: traffic.Rows,
                       device, dtype=torch.float64, fault=None) -> dict:
    """The reference's readings of the first steps: the same rows, the same
    initial table (worked out again from the seed)."""
    held, batches = reference_batches(first, m.num_bits, device)
    V0 = initial_factors(seed, 1 << m.num_bits, m.K, m.init_scale, device)
    V0h = V0[held]
    del V0
    return reference.steps(batches, V0h, m, dtype=dtype, fault=fault)


def first_batches(rows: traffic.Rows) -> traffic.Rows:
    """The checked steps' rows, on the host."""
    n = CHECKED_STEPS * rows.batch_size
    return traffic.Rows(rows.ids[:n].cpu(), rows.labels[:n].cpu(),
                        None if rows.fields is None else rows.fields[:n].cpu(),
                        rows.batch_size)


def card_state() -> str | None:
    """The card's name, power limit and draw, SM clock and its maximum, and
    temperature, by nvidia-smi (read once the window has closed)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             t_main: float | None = None) -> tuple[dict, dict]:
    """Set-up, window, trace and check; ``t_start`` is the process's start
    and ``t_main`` the start of its main module, on the ``perf_counter``
    clock. Returns (the result line, the set-up phases in seconds)."""
    from difacto_tpu_torch.learners.sgd import SGDLearner

    device = torch.device(device)
    cell = load_cell(root, workload)
    t_main = t_start if t_main is None else t_main
    phases = {"interpreter": t_main - t_start,
              "import": time.perf_counter() - t_main}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        sync(device)
    phases["cuda_init"] = time.perf_counter() - t

    t = time.perf_counter()
    from difacto_tpu_torch.data import _native
    if device.type == "cuda":
        from difacto_tpu_torch.ops import cuda as kernels
        kernels.library()
    _native.available()
    phases["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    prefix = f"{MEMORY_ROOT}/{workload}"
    traffic.remove_parts(prefix)
    rows = traffic.make_rows(cell.traffic, seed, device)
    fmt = cell.config["conf"]["data_format"]
    data_in = traffic.write_parts(rows, fmt, prefix)
    cfg = build_config(cell, data_in)
    model = reference.Model.of(cell.config["conf"])
    first = first_batches(rows)
    # the traced run's counts (the untraced runs, which report setup_s,
    # skip this host work)
    shapes = batch_counts(rows, model) if traced else None
    del rows
    sync(device)
    phases["inputs"] = time.perf_counter() - t

    t = time.perf_counter()
    learner = SGDLearner(cfg, device=device)
    V0 = initial_factors(seed, learner.store.num_rows, model.K,
                         model.init_scale, device)
    st = learner.state
    for leaf in ("w", "z", "n", "cnt", "nV"):
        getattr(st, leaf).zero_()
    st.V.copy_(V0.T)
    hooks = Hooks(learner.store, V0)
    del V0, st
    sync(device)
    phases["state_init"] = time.perf_counter() - t

    t = time.perf_counter()
    learner.train_epoch(0)
    sync(device)
    phases["cache_fill"] = time.perf_counter() - t
    traffic.remove_parts(prefix)
    readings = hooks.take_readings()

    t = time.perf_counter()
    learner.train_epoch(1)
    sync(device)
    phases["warmup"] = time.perf_counter() - t

    if traced:
        hooks.host_ms = []
    win = run_window(learner, hooks, 2, seconds, device)
    setup_s = win["t0"] - t_start
    host_ms, hooks.host_ms = hooks.host_ms, None
    summ = None
    if traced:
        epochs = math.ceil(TRACED_STEPS / len(shapes))
        summ = run_traced(learner, hooks, win["epoch"], epochs, device)
        traced_steps = epochs * len(shapes)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    smi = card_state() if device.type == "cuda" else None

    # the program's state goes before the reference runs
    del learner, hooks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_readings(seed, model, first, device)
    sync(device)
    check_s = time.perf_counter() - t
    numbers = check.compare(readings, ref)
    verdicts = check.judge(numbers, cell.limits)

    metrics = {}
    if not traced:
        values = {
            "train_examples_per_s": win["examples"] / win["wall_s"],
            "train_step_ms_p95": float(np.percentile(win["step_ms"], 95)),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = dict(phases=phases, window=win, host_ms=host_ms, trace=summ,
                   traced_steps=traced_steps, shapes=shapes, counts=counts,
                   device=device.type)
        for m in cell.per_layer:
            v = load_reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if smi:
        dev["smi"] = smi
    out = {"correct": all(verdicts.values()), "attempted": win["steps"],
           "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = summ.busy_s
        dev["window_s"] = summ.window_s
        out["breakdown"] = {"device_ops": trace.top(summ.by_name),
                            "idle_gaps": trace.top(summ.gaps)}
        out["bound_by"] = {"step_mfu.train": sorted({
            counts.least_time_s(
                counts.step_bytes(s["B"], s["L"], s["n"], s["K"],
                                  s["fields"]),
                counts.step_flops(s["loss"], s["B"], s["L"], s["n"], s["K"],
                                  s["F"]))[1] for s in shapes})}
    out["check_s"] = check_s
    out["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                     for k, v in numbers.items()}
    return out, phases


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def main(argv: list[str], t_start: float, t_main: float) -> int:
    ap = argparse.ArgumentParser(prog="python -m fmbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(root, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"fmbench: needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    # the program's own tracing would profile epoch 0 and write a file
    os.environ.pop("DIFACTO_PROFILE", None)
    out, phases = run_cell(root, a.workload, a.seed, a.seconds,
                           bool(a.trace), torch.device("cuda", 0), t_start,
                           t_main)
    bad = banned_modules()
    if bad:
        print(f"fmbench: modules of JAX or of the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(json.dumps({"setup_phases_s": phases}), flush=True)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
