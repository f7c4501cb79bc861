"""The per-slot accumulate primitive over a row-major payload, on the card.

Counterpart of ``scripts/bench_slot_accum.py``: ``out[sid[j], :] +=
pay[j, :]`` into a zeroed ``[1024, 128]`` block accumulator, for 2^19
sorted slot ids in [0, 1024) and a row-major ``[2^19, 128]`` f32 payload.
The TPU script measured a serial read-modify-write per slot; the CUDA
kernel (csrc/slot_accum.cu) is a two-pass segmented sum in which a slot
is one coalesced 512-byte read. It is ``segsum_sorted``'s contract in the
other payload layout (row-major where that one is planar), so its time
per slot beside that kernel's is the second of the layout measurements
(the first is probes/hw_packed_pairs.py).

Prints the relative error against ``np.add.at`` (float64 here: the
reference the script uses, without its float32 rounding) and the time per
slot.

    python -m difacto_tpu_torch.probes.bench_slot_accum [n_slots_log2]

``rows=`` shrinks the accumulator.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import cuda
from . import common

R = 1024          # accumulator rows (one table block)
PP = 128          # payload width
CHUNK = 128       # slots per pass-1 block in csrc/slot_accum.cu
LOG2 = 19


def slot_accum_plain(sid: torch.Tensor, pay: torch.Tensor,
                     num_rows: int = R) -> torch.Tensor:
    out = pay.new_zeros((num_rows, pay.shape[1]))
    return out.index_add_(0, sid.long(), pay)


def slot_accum(sid: torch.Tensor, pay: torch.Tensor,
               num_rows: int = R) -> torch.Tensor:
    """``out [num_rows, 128]`` with ``out[sid[j]] += pay[j]`` from zero:
    ``sid`` i32 [n] sorted with values in [0, num_rows), ``pay`` f32
    [n, 128] row-major. Rows no slot names are exactly 0; the sums repeat
    bit for bit (no atomics)."""
    if pay.device.type == "cpu":
        return slot_accum_plain(sid, pay, num_rows)
    dev, n = pay.device, sid.shape[0]
    cuda.require(sid, "sid", torch.int32, (n,), dev)
    cuda.require(pay, "pay", torch.float32, (n, PP), dev)
    nch = (n + CHUNK - 1) // CHUNK
    out = torch.empty((num_rows, PP), dtype=torch.float32, device=dev)
    # scratch: each chunk's first and last piece, per column
    head = torch.empty((nch, PP), dtype=torch.float32, device=dev)
    tail = torch.empty((nch, PP), dtype=torch.float32, device=dev)
    rc = cuda.library().dft_slot_accum(
        sid.data_ptr(), pay.data_ptr(), out.data_ptr(), head.data_ptr(),
        tail.data_ptr(), n, num_rows, cuda.stream(dev))
    cuda.check(rc, "slot_accum")
    cuda.LAUNCHES["slot_accum"] += 1
    return out


def main(argv=None, device=None) -> int:
    words, o = common.parse_args(argv, dict(rows=R))
    nslots = 1 << (int(words[0]) if words else LOG2)
    rows = o["rows"]
    dev = common.start("bench_slot_accum", device)
    rng = np.random.default_rng(0)
    # sorted ids like the real pipeline (sorted within a block slice)
    sid = np.sort(rng.integers(0, rows, nslots)).astype(np.int32)
    pay = rng.normal(0, 1, (nslots, PP)).astype(np.float32)
    sid_d, pay_d = torch.from_numpy(sid).to(dev), torch.from_numpy(pay).to(dev)
    got = slot_accum(sid_d, pay_d, rows).cpu().numpy()
    want = np.zeros((rows, PP), np.float64)
    np.add.at(want, sid, pay.astype(np.float64))
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
    print(f"rel err vs numpy: {err:.2e}", flush=True)
    ms = common.time_ms(lambda: slot_accum(sid_d, pay_d, rows), dev, 10)
    per = "" if ms is None else f" => {ms * 1e6 / nslots:.3f} ns/slot"
    print(f"{nslots} slots x {PP} lanes into {rows} rows: "
          f"{common.fmt_ms(ms)}{per}", flush=True)
    # float32 sums of ~nslots/rows unit normals: a few 1e-7 relative
    return 0 if err < 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
