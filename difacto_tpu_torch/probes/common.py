"""What the probes share: the flagship ids, the timer, the device rule.

The flagship shapes are those of the JAX package's benchmark
(``bench.py:55-79``): batches of 16384 rows x 40 features, Zipf(1.2) raw
ids hashed into 2^22 table rows, K = 16, and a 131,072-lane bucket of
unique ids. Everything is made from a seed with numpy.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..data.batch_iter import Batch
from ..utils.device import resolve_device

BATCH, NNZ, NUM_BITS, K, U = 16384, 40, 22, 16, 131072
HASH = np.uint64(0x9E3779B97F4A7C15)


def parse_args(argv, defaults: dict) -> tuple[list[str], dict]:
    """Split ``argv`` into positional words and ``key=value`` overrides of
    ``defaults`` (integers; an unknown key is fatal). The positionals are
    each probe's own, as its JAX script takes them; the overrides shrink
    the shapes for a CPU run."""
    words, opts = [], dict(defaults)
    for a in argv or []:
        key, eq, val = a.partition("=")
        if not eq:
            words.append(a)
        elif key in opts:
            opts[key] = int(val)
        else:
            raise SystemExit(f"unknown option {key!r}; known: {sorted(opts)}")
    return words, opts


def zipf_ids(rng, rows: int, nnz: int = NNZ,
             num_bits: int = NUM_BITS) -> np.ndarray:
    """Zipf(1.2) raw feature ids hashed into 2^num_bits rows (Criteo's
    power-law key distribution), int64 [rows, nnz]."""
    z = rng.zipf(1.2, size=(rows, nnz)).astype(np.uint64)
    with np.errstate(over="ignore"):
        return ((z * HASH) % np.uint64(1 << num_bits)).astype(np.int64)


def flagship_batch(seed: int, batch: int = BATCH, nnz: int = NNZ,
                   num_bits: int = NUM_BITS) -> Batch:
    """One benchmark batch: Zipf ids, unit values, random labels."""
    rng = np.random.default_rng(seed)
    ids = zipf_ids(rng, batch, nnz, num_bits).astype(np.int32)
    return Batch(ids, np.ones((batch, nnz), np.float32),
                 (rng.random(batch) > 0.5).astype(np.float32),
                 np.ones(batch, np.float32))


def uniform_batch(seed: int, batch: int = BATCH, nnz: int = NNZ,
                  num_bits: int = NUM_BITS) -> Batch:
    """:func:`flagship_batch` with every id uniform over the 2^num_bits
    rows, so nearly every id is rare."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1 << num_bits, (batch, nnz), np.int32)
    return Batch(ids, np.ones((batch, nnz), np.float32),
                 (rng.random(batch) > 0.5).astype(np.float32),
                 np.ones(batch, np.float32))


def flagship_uniques(rng, batch: int = BATCH, nnz: int = NNZ,
                     num_bits: int = NUM_BITS, u: int = U):
    """The sorted unique ids of one batch's slots in a ``u``-lane bucket,
    the sentinel ``N`` on the lanes past them: (uids i32 [u], valid bool
    [u])."""
    n = 1 << num_bits
    raw = np.unique(zipf_ids(rng, batch * nnz, 1, num_bits))
    nv = min(len(raw), u - 1)
    uids = np.full(u, n, np.int32)
    uids[:nv] = raw[:nv]
    return uids, np.arange(u) < nv


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    a warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_times(fn, reps: int = 20) -> dict[str, float]:
    """Mean time per call of ``fn`` of each kernel it runs on the card, by
    kernel name, from a ``torch.profiler`` trace of ``reps`` calls. A
    trace that comes back without a device event (seen once in a while
    for microsecond kernels) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict[str, float] = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                t = getattr(e, "self_device_time_total", None)
                us = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
                out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
        if out:
            break
    return out


def kernel_ms(fn, reps: int = 20,
              name: str | tuple[str, ...] | None = None) -> float:
    """Mean time the card's kernels take per call of ``fn`` (only those
    whose name contains ``name``, or one of them, when given). For a
    kernel of a few microseconds :func:`cuda_ms` measures how fast the
    host enqueues (Python, ctypes, the allocator); this is the kernels'
    own time."""
    names = (name,) if isinstance(name, str) else name
    return sum(ms for key, ms in kernel_times(fn, reps).items()
               if names is None or any(n in key for n in names))


_FLUSH: dict[torch.device, torch.Tensor] = {}


def flush_l2(dev: torch.device) -> None:
    """Write 256 MB (five times an H100's L2), so the next kernel finds
    its rows in device memory."""
    if dev not in _FLUSH:
        _FLUSH[dev] = torch.empty(1 << 26, device=dev)
    _FLUSH[dev].zero_()


def kernel_ms_in_turns(dev: torch.device, calls: dict,
                       names: str | tuple[str, ...] | None = None) -> dict:
    """:func:`kernel_ms` of each of ``calls`` (label -> function), each
    the mean of two timings taken in the order of ``calls`` and then back,
    so a drift of the card's clock falls on all alike:
    ``{"warm": {label: ms}, "cold": {label: ms}}``, warm as the loop runs
    them (the same rows every call, so they sit in the L2), cold after
    :func:`flush_l2` before every call (its own kernel is not counted:
    give ``names``)."""
    order = list(calls) + list(calls)[::-1]
    out = {}
    for temp, pre in (("warm", lambda: None), ("cold", lambda: flush_l2(dev))):
        ms = dict.fromkeys(calls, 0.0)
        for label in order:
            ms[label] += kernel_ms(lambda: (pre(), calls[label]()),
                                   name=names) / 2
        out[temp] = ms
    return out


def time_ms(fn, dev: torch.device, reps: int = 20,
            timer=cuda_ms) -> float | None:
    """``timer`` (:func:`cuda_ms` or :func:`kernel_ms`) on the card; on
    the CPU one call and no time (a CPU time is not a figure of the
    port)."""
    if dev.type == "cuda":
        return timer(fn, reps)
    fn()
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:.4f} ms"


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return "cpu: the kernels' plain versions, no times"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]


def start(name: str, device) -> torch.device:
    """Resolve the device under the port's rule and print the probe's
    first line."""
    dev = resolve_device(device)
    print(f"{name} on {card_line(dev)}", flush=True)
    return dev
