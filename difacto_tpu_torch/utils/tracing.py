"""Profiling / tracing hooks.

Port of ``difacto_tpu/utils/tracing.py`` (reference: wall-clock progress
rows plus ps-lite's ``PS_VERBOSE`` message dump, SURVEY.md §5):

  * ``DIFACTO_PROFILE=<dir>`` traces the first profiled region with
    ``torch.profiler`` (CPU activity, and CUDA activity when a card is
    present) and writes it into <dir> as one Chrome trace JSON
    (``<region>.pt.trace.json``, viewable in Perfetto or
    chrome://tracing), where the JAX package writes a ``jax.profiler``
    trace. The first region wins, as there. ``torch.profiler`` is imported
    only when the variable is set. With a card, the log gets the region's
    device time by program span (:func:`span_times`);
  * :func:`span` marks a phase of the program (``difacto.epoch``,
    ``difacto.step``, ``difacto.pull``, ...) on the timeline of whatever
    ``torch.profiler`` is recording, the program's own or a caller's;
    with none recording it costs a flag read;
  * counters, in groups of a flat registry (:func:`counter_group`): the
    kernel launches (``launch``, ops/cuda.py's ``LAUNCHES``) and the
    train step's work (``step``: :data:`STEP`), bumped where the work
    happens; :func:`counters` takes a snapshot, :func:`delta` the change
    between two. Reading one never waits for the card;
  * ``DIFACTO_VERBOSE=1`` asks for debug-level logging (``cli.main``),
    which adds each train step's counter deltas to the log;
  * :class:`StepTimer` measures step wall time; once the process uses a
    card it synchronizes before it reads the clock, where the JAX package
    forces a fetch.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

log = logging.getLogger("difacto_tpu_torch")


# set by the first profiled region of the process; reset() clears it
_traced = False


def verbose() -> bool:
    return os.environ.get("DIFACTO_VERBOSE", "") not in ("", "0")


def reset() -> None:
    """Let the next profiled region trace again (a process that wants a
    second trace, as the tests do)."""
    global _traced
    _traced = False


@contextlib.contextmanager
def profile_region(name: str):
    """Trace a region if DIFACTO_PROFILE is set (first region wins: the
    flag is per process, as the JAX profiler's single trace is, until
    :func:`reset`)."""
    global _traced
    prof_dir = os.environ.get("DIFACTO_PROFILE")
    if not prof_dir or _traced:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    _traced = True
    os.makedirs(prof_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(prof_dir, f"{name}.pt.trace.json")
    log.info("profiling %s -> %s", name, path)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    st = span_times(prof.events())
    if st.by_span:
        log.info("%s device ms by span: %s; idle ms by span: %s; "
                 "unattributed ms: %.3f", name, _ms(st.by_span),
                 _ms(st.idle_by_span), st.unattributed_s * 1e3)


# -- spans --------------------------------------------------------------------

SPAN_PREFIX = "difacto."
_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
# a range of RecordScope FUNCTION: it lands in the trace as the host event
# of the name, where a user-scope ``record_function`` would also add a
# device-side annotation event that a reader of device operations would
# have to tell from the kernels
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A named range around a phase of the program, on the timeline of the
    ``torch.profiler`` that is recording, if one is: every kernel, copy and
    runtime call issued inside it falls within it, on the trace's clock.
    With none recording it returns one shared ``nullcontext`` (no
    dispatcher call, no allocation). Names start with ``difacto.``."""
    if not _recording():
        return _NULL
    return _Range(name)


@dataclass
class SpanTimes:
    """A trace read by program span (:func:`span_times`), in seconds.
    ``by_span``: device time by the innermost span open where each
    operation was launched (``(none)`` outside every span, or on another
    thread); ``idle_by_span``: the device's idle gaps by the innermost span
    open at each gap's start; ``unattributed_s``: device time of
    operations whose runtime call the trace does not hold."""

    by_span: dict = field(default_factory=dict)
    idle_by_span: dict = field(default_factory=dict)
    unattributed_s: float = 0.0


OUTSIDE = "(none)"


def _is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _innermost(spans, times):
    """The innermost span open at each of ``times`` (sorted), by one sweep
    with a stack: ``spans`` are (start, end, name) of one thread, sorted by
    start and then by end, latest first, so that they nest."""
    stack, i, out = [], 0, []
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else OUTSIDE)
    return out


def span_times(events, window: tuple | None = None) -> SpanTimes:
    """Read a ``torch.profiler`` trace (``prof.events()``; times in µs) by
    the program's spans, on the thread that runs them. Each device
    operation is attributed to the innermost span open when the runtime
    call that issued it started (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...: the host event that carries the operation's
    ``id``, CUPTI's correlation id), whether an aten operator or a
    hand-written kernel's wrapper made the call. Device-side annotation
    ranges are not operations. ``window`` (start, end) clips the
    operations and bounds the idle gaps; by default the extent of the
    spans."""
    evs = list(events)
    host = [e for e in evs if not _is_device(e)]
    spans = [e for e in host if e.name.startswith(SPAN_PREFIX)]
    if not spans:
        return SpanTimes()
    thread = min(spans, key=lambda e: e.time_range.start).thread
    tl = sorted(((e.time_range.start, e.time_range.end, e.name)
                 for e in spans if e.thread == thread),
                key=lambda s: (s[0], -s[1]))
    w0, w1 = window or (tl[0][0], max(s[1] for s in tl))
    calls = {e.id: e for e in host if e.name.startswith("cu")}
    launched, ops, unlinked = [], [], 0.0
    by_span: dict = defaultdict(float)
    for e in evs:
        if (not _is_device(e) or getattr(e, "is_user_annotation", False)
                or e.name.startswith(SPAN_PREFIX)):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        ops.append((a, b))
        call = calls.get(e.id)
        if call is None:
            unlinked += b - a
        elif call.thread != thread:
            by_span[OUTSIDE] += (b - a) * 1e-6
        else:
            launched.append((call.time_range.start, b - a))
    launched.sort()
    for (_, d), name in zip(launched, _innermost(tl, [t for t, _ in
                                                      launched])):
        by_span[name] += d * 1e-6
    ops.sort()
    gaps, end = [], w0
    for a, b in ops:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    idle: dict = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(tl, [a for a, _ in gaps])):
        idle[name] += (b - a) * 1e-6
    return SpanTimes(dict(by_span), dict(idle), unlinked * 1e-6)


def _ms(d: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.3f}"
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1]))


# -- counters -----------------------------------------------------------------

_GROUPS: dict[str, dict] = {}


def counter_group(name: str, counters: dict) -> dict:
    """Register ``counters`` (name -> number) as the group ``name`` and
    return the same dict, which its owner bumps in place."""
    _GROUPS[name] = counters
    return counters


# the learner's train steps (learners/sgd.py, parallel/store.py): steps;
# slots B*L; lanes, the unique lanes Ub the kernels launch over; unique_rows,
# the distinct rows among them (host-prepped batches only: a batch
# localized on the device has no host count); batches taken from the
# learner's batch cache or streamed through the host prep; batch_wait_s,
# the host clock in the batch iterator's next(); host_reads, blocking reads
# of device tensors to the host (:func:`to_host`); ids_dropped, the ids a
# full routing bucket or unique bucket dropped (StepMetrics.dropped_ids,
# as the learner folds it)
STEP = counter_group("step", {
    "steps": 0, "slots": 0, "lanes": 0, "unique_rows": 0,
    "batches_replayed": 0, "batches_streamed": 0, "batch_wait_s": 0.0,
    "host_reads": 0, "ids_dropped": 0})


def counters() -> dict:
    """A snapshot of every group, flat: ``{"step.lanes": n, ...}``."""
    return {f"{g}.{k}": v for g, c in _GROUPS.items() for k, v in c.items()}


def delta(before: dict, after: dict | None = None) -> dict:
    """The counters that moved from ``before`` to ``after`` (default:
    now), and by how much."""
    after = counters() if after is None else after
    out = {k: v - before.get(k, 0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


def format_counters(d: dict) -> str:
    return " ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in sorted(d.items())) or "none"


def reset_counters() -> None:
    """Zero every group."""
    for c in _GROUPS.values():
        for k in c:
            c[k] = type(c[k])(0)


def to_host(t) -> np.ndarray:
    """A tensor's values as a NumPy array, counted in ``step.host_reads``
    (a device tensor's read waits for the card); anything else through
    ``np.asarray``."""
    if isinstance(t, torch.Tensor):
        STEP["host_reads"] += 1
        return t.detach().cpu().numpy()
    return np.asarray(t)


class StepTimer:
    """Wall-clock step timing with coarse percentile summary. Once the
    process uses a card, each clock read waits for its queued work."""

    def __init__(self):
        self.times: list[float] = []
        self._t = None

    @staticmethod
    def _now() -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return time.perf_counter()

    def start(self) -> None:
        self._t = self._now()

    def stop(self) -> None:
        if self._t is not None:
            self.times.append(self._now() - self._t)
            self._t = None

    def summary(self) -> str:
        if not self.times:
            return "no steps timed"
        ts = sorted(self.times)
        n = len(ts)
        return (
            f"{n} steps: p50 {ts[n // 2] * 1e3:.1f}ms "
            f"p90 {ts[int(n * 0.9)] * 1e3:.1f}ms mean {sum(ts) / n * 1e3:.1f}ms"
        )
