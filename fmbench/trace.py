"""What a ``torch.profiler`` trace of the measured steps says: the device's
operations and busy time inside the traced window, and the host activity
during each gap in which the device was idle.

The harness marks the window (``fmbench.window``), each epoch
(``fmbench.epoch``) and each call of the store's step entry
(``fmbench.step``) with ``record_function`` spans; the program's own
operations, runtime calls and kernels are what the profiler records. The
program marks its phases with spans of its own (``difacto.pull``, ...;
``utils/tracing.py``): of them this file takes only their names, and reads
the window by them itself.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

SPANS = ("fmbench.step", "fmbench.epoch", "fmbench.window")
# the program's spans: the start of their names
PROGRAM_SPAN = "difacto."
# where no program span is open, or the launch was on another thread
OUTSIDE = "(none)"


@dataclass
class Spans:
    """The window read by the program's spans, in seconds. ``by_span``:
    device time by the innermost span open on the harness's thread when
    the runtime call that issued each operation started (the host event
    with the operation's ``id``, CUPTI's correlation id); ``idle_by_span``:
    the device's idle gaps by the innermost span open at each gap's start;
    ``unlinked_s``: device time whose runtime call the trace lacks."""

    by_span: dict = field(default_factory=dict)
    idle_by_span: dict = field(default_factory=dict)
    unlinked_s: float = 0.0


@dataclass
class Summary:
    """Device operations clipped to the window (seconds), in start order."""

    window_s: float = 0.0
    busy_s: float = 0.0
    ops: list = field(default_factory=list)          # (name, start, dur)
    by_name: dict = field(default_factory=dict)      # name -> seconds
    gaps: dict = field(default_factory=dict)         # host label -> seconds
    # the window by the program's spans; None where there is no window
    spans: Spans | None = None


def _is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def summarize(prof) -> Summary:
    """Read the profiler's events; an empty Summary when the window span
    is missing (no trace)."""
    evs = list(prof.events())
    win = [e for e in evs if e.name == "fmbench.window" and not _is_device(e)]
    if not win:
        return Summary()
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    ops, launched = [], []
    for e in evs:
        if not _is_device(e) or e.name.startswith("fmbench."):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            ops.append((e.name, a, b - a))
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(PROGRAM_SPAN)):
                launched.append((e.id, b - a))
    ops.sort(key=lambda o: o[1])
    by_name: dict[str, float] = defaultdict(float)
    busy, gaps_at = 0.0, []
    cur0 = cur1 = None
    prev_end = w0
    for name, a, d in ops:
        by_name[name] += d * 1e-6
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if a > prev_end:
                gaps_at.append((prev_end, a))
            cur0, cur1 = a, a + d
        else:
            cur1 = max(cur1, a + d)
        prev_end = max(prev_end, a + d)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > prev_end:
        gaps_at.append((prev_end, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in evs if not _is_device(e) and e.thread == thread),
                  key=lambda h: (h[0], -h[1]))
    gaps: dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps_at, _host_labels(host, gaps_at)):
        gaps[label] += (b - a) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                   ops=[(n, a * 1e-6, d * 1e-6) for n, a, d in ops],
                   by_name=dict(by_name), gaps=dict(gaps),
                   spans=_by_span(evs, thread, launched, gaps_at))


def _by_span(evs, thread, launched, gaps_at) -> Spans:
    """The device operations ``launched`` ((id, µs) in the window) and the
    idle gaps ``gaps_at`` ((start, end) in µs, in time order) by the
    program's spans on ``thread``."""
    tl = sorted(((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if not _is_device(e) and e.thread == thread
                 and e.name.startswith(PROGRAM_SPAN)),
                key=lambda s: (s[0], -s[1]))
    calls = {e.id: e for e in evs
             if not _is_device(e) and e.name.startswith("cu")}
    by_span: dict[str, float] = defaultdict(float)
    mine, unlinked = [], 0.0
    for i, d in launched:
        call = calls.get(i)
        if call is None:
            unlinked += d
        elif call.thread != thread:
            by_span[OUTSIDE] += d * 1e-6
        else:
            mine.append((call.time_range.start, d))
    mine.sort()
    for (_, d), name in zip(mine, _innermost(tl, [t for t, _ in mine])):
        by_span[name] += d * 1e-6
    idle: dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps_at, _innermost(tl, [a for a, _ in gaps_at])):
        idle[name] += (b - a) * 1e-6
    return Spans(dict(by_span), dict(idle), unlinked * 1e-6)


def _innermost(spans, times):
    """The innermost of ``spans`` open at each of ``times`` (sorted), by
    one sweep with a stack: ``spans`` are (start, end, name) of one
    thread, sorted by start and then by end, latest first, so they nest."""
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


def _host_labels(host, gaps_at):
    """``span/op`` at the start of each gap (in time order): the innermost
    harness span and the innermost other host event running then
    (``python`` when none is). The events of one thread nest, so one sweep
    with a stack of the open events finds both."""
    stack, i, out = [], 0, []
    for t, _ in gaps_at:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        span = next((n for _, e, n in reversed(stack)
                     if n in SPANS and e >= t), "fmbench")
        op = next((n for _, e, n in reversed(stack)
                   if n not in SPANS and e >= t), "python")
        out.append(f"{span}/{op}")
    return out


def top(d: dict) -> list:
    """The ten largest entries, names cut to 96 characters (a kernel's
    full signature runs to hundreds)."""
    return [[k[:96], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
