"""Profiling / tracing hooks.

Port of ``difacto_tpu/utils/tracing.py`` (reference: wall-clock progress
rows plus ps-lite's ``PS_VERBOSE`` message dump, SURVEY.md §5):

  * ``DIFACTO_PROFILE=<dir>`` traces the first profiled region with
    ``torch.profiler`` (CPU activity, and CUDA activity when a card is
    present) and writes it into <dir> as one Chrome trace JSON
    (``<region>.pt.trace.json``, viewable in Perfetto or
    chrome://tracing), where the JAX package writes a ``jax.profiler``
    trace. The first region wins, as there. ``torch.profiler`` is imported
    only when the variable is set;
  * ``DIFACTO_VERBOSE=1`` asks for debug-level logging;
  * :class:`StepTimer` measures step wall time; once the process uses a
    card it synchronizes before it reads the clock, where the JAX package
    forces a fetch.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

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
