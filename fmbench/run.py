"""One run of one benchmark cell.

    python -m fmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration (its
file under ``fmbench/configs/``) and a traffic mix
(``fmbench/traffic/<name>.json``); its correctness limits are
``fmbench/limits/<cell>.json``, each per-layer metric is read by
``fmbench/metrics/<metric>.py``, and the configuration's model (its file's
``model`` key, else its ``conf``'s ``loss``, else ``fm``) is
``fmbench/models/<model>.py``: its initial state, the readings the check
compares, its plain reference and its counts. Nothing here names a cell
or a model.

Set-up builds one ``SGDLearner`` of ``difacto_tpu_torch`` on the card
(``cache_batches=1 cache_on_device=1``), writes the benchmark's own initial
state into it (the model's ``place``), and trains epoch 0, which streams
the traffic's rows (written to ``memory://`` in the configuration's data
format) through the learner's host prep into its device batch cache; the
first three steps are kept for the correctness check. Epoch 1 warms up,
on the same batches. The window then runs ``train_epoch(e)`` for e = 2,
3, ... over the cache, as epochs past the first of ``python -m
difacto_tpu_torch <conf>`` do, and stops at the first epoch boundary after
``--seconds``.

``--trace 1`` runs the same window with the host's enqueue of each step
timed, then a fixed number of epochs under ``torch.profiler``, and prints
the per-layer metrics; their readers get the trace, the program's spans
over it and its counters. Once the window has closed and the program's
state is freed, the model's plain reference trains the same first three
steps and fmbench/check.py compares them.
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
CHECKED_STEPS = reference.CHECKED_STEPS
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


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Hooks:
    """Wraps the store's step entry (``train_step_prepped``), the one call
    the learner makes a step. It counts the calls; during the first
    ``CHECKED_STEPS`` of epoch 0 it hands each step's output to the model's
    ``keep``, which keeps what the correctness check reads in ``kept``; in
    the window it stamps each step's start (a CUDA event on the stream, or
    the host clock on the CPU) and, when asked, times the host's enqueue of
    the first ``ENQUEUE_STEPS`` calls of each epoch and marks each step for
    the profiler."""

    def __init__(self, store, keep, kept: dict):
        self.orig = store.train_step_prepped
        store.train_step_prepped = self.step
        self.calls = 0
        self.keep = keep
        self.kept = kept
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
            self.keep(self.kept, out[0], out[1], self.calls)
        return out

    def take_readings(self) -> dict:
        """The kept readings as floats (a list stays a list)."""
        kept, self.kept = self.kept, None
        return {k: [float(x) for x in v] if isinstance(v, list) else float(v)
                for k, v in kept.items()}


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


def _load(path: Path, name: str):
    """The module of the file ``path``, run anew, as ``sys.modules[name]``
    (where a dataclass of it looks itself up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, name: str):
    path = root / DIR / "metrics" / f"{name}.py"
    return _load(path, f"fmbench_metric_{name.replace('.', '_')}").read


def load_model(root: Path, config: dict):
    """The module of a configuration file's model: ``fmbench/models/
    <model>.py`` by its ``model`` key, else its ``conf``'s ``loss``, else
    ``fm``. A model with no module stops the run."""
    name = config.get("model") or config["conf"].get("loss", "fm")
    path = root / DIR / "models" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"fmbench: the configuration {config.get('name')!r}"
                         f" names the model {name!r}, which has no module "
                         f"{DIR}/models/{name}.py")
    return _load(path, f"fmbench_model_{name}")


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
    from difacto_tpu_torch.utils import tracing

    device = torch.device(device)
    cell = load_cell(root, workload)
    mod = load_model(root, cell.config)
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
    model = mod.Model.of(cell.config["conf"])
    first = first_batches(rows)
    # the traced run's counts (the untraced runs, which report setup_s,
    # skip this host work)
    shapes = ([mod.shape(rows.batch(i), model)
               for i in range(rows.num_batches)] if traced else None)
    del rows
    sync(device)
    phases["inputs"] = time.perf_counter() - t

    t = time.perf_counter()
    learner = SGDLearner(cfg, device=device)
    hooks = Hooks(learner.store, mod.keep,
                  mod.place(learner, seed, device, model))
    sync(device)
    phases["state_init"] = time.perf_counter() - t

    t = time.perf_counter()
    c0 = tracing.counters()
    learner.train_epoch(0)
    sync(device)
    phases["cache_fill"] = time.perf_counter() - t
    # the program's counters (groups step and launch) that moved
    setup_counters = tracing.delta(c0)
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
        c0 = tracing.counters()
        summ = run_traced(learner, hooks, win["epoch"], epochs, device)
        train_counters = tracing.delta(c0)
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
    ref = mod.reference(seed, first, model, device)
    sync(device)
    check_s = time.perf_counter() - t
    numbers = check.compare(readings, ref, mod.LEAVES)
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
                   spans=summ.spans, traced_steps=traced_steps, shapes=shapes,
                   counts=counts, model=mod, device=device.type,
                   counters={"setup": setup_counters,
                             "train": train_counters})
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
            counts.least_time_s(mod.step_bytes(s), mod.step_flops(s))[1]
            for s in shapes})}
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
