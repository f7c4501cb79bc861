"""Flagship apply-kernel A/B: B2's planar kernel (``apply_pairs``, one
table row per thread) against the tile design for the card
(``apply_pairs2`` by the word ``tiles``, csrc/planar_apply.cu: staged
payload, compacted rows), and that design's ``rmwonly`` floor.

Counterpart of ``scripts/hw_apply2.py``. There the question was whether a
grid step doing two unique windows recovers per-step overhead; on a CUDA
card it reads: how close does a planar apply come to the rate at which
the card retires scattered 32-byte sectors, and is what is left the
kernel's cost or the memory system's?

Setup as the script's: the sorted unique ids of one flagship batch
(16384 x 40 Zipf(1.2) slots hashed into 2^22 rows) in a 131,072-lane
bucket, K = 16, ``V_threshold = 0`` so every touched row updates its
factors, a random-normal ``[3+K, U]`` payload masked to the real lanes,
and a fresh state for each timed series. Prints the three times by CUDA
events, their ratios, the kernels' own times in turns (warm and with the
L2 flushed) on the card, by every stage word of ``apply_pairs2``, and
the largest difference between the two final states; the rmwonly series
must leave its state's bits.

    python -m difacto_tpu_torch.probes.hw_apply2
    python -m difacto_tpu_torch.probes.hw_apply2 batch=512 num_bits=13 u=1024

The second form shrinks the shapes (for a CPU run through
``main(argv, device="cpu")``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import FMParam
from ..ops import pair_sweep
from ..updaters.updater import LEAVES, FMUpdater
from . import common

ITERS = 30


def main(argv=None, device=None) -> int:
    _, o = common.parse_args(argv, dict(
        batch=common.BATCH, nnz=common.NNZ, num_bits=common.NUM_BITS,
        k=common.K, u=common.U, iters=ITERS))
    dev = common.start("hw_apply2", device)
    n, k, u = 1 << o["num_bits"], o["k"], o["u"]
    rng = np.random.default_rng(0)
    p = FMParam()
    p.V_dim, p.V_threshold = k, 0
    upd = FMUpdater(p)
    uids_np, valid = common.flagship_uniques(rng, o["batch"], o["nnz"],
                                             o["num_bits"], u)
    uids = torch.from_numpy(uids_np).to(dev)
    pay = torch.from_numpy(
        (rng.normal(size=(3 + k, u)) * valid[None, :]).astype(np.float32)
    ).to(dev)
    touched = int((pay[2 + k] > 0).sum())
    print(f"uniques {int(valid.sum())} of {u} lanes, {touched} touched rows, "
          f"table 2^{o['num_bits']} rows, K {k}", flush=True)

    def series(fn):
        """One warm-up and ``iters`` timed applications on a fresh state:
        (ms per application, the final state)."""
        state = upd.init_state(n, 1, dev)
        ms = common.time_ms(lambda: fn(state, uids, pay, p), dev, o["iters"])
        return ms, state

    t1, s1 = series(pair_sweep.apply_pairs)
    print(f"apply_pairs  (B2, a row a thread): {common.fmt_ms(t1)}",
          flush=True)
    t2, s2 = series(lambda *a: pair_sweep.apply_pairs2(*a, stage="tiles"))
    ratio = "" if t1 is None else f"  ({t2 / t1:.3f}x apply_pairs)"
    print(f"apply_pairs2 tiles:                {common.fmt_ms(t2)}{ratio}",
          flush=True)
    t3, s3 = series(lambda *a: pair_sweep.apply_pairs2(*a, stage="rmwonly"))
    ratio = "" if t2 is None else f"  ({t3 / t2:.3f}x tiles)"
    print(f"apply_pairs2 rmwonly:              {common.fmt_ms(t3)}{ratio}",
          flush=True)
    diff = max(float((getattr(s1, name) - getattr(s2, name)).abs().max())
               for name in LEAVES if getattr(s1, name).numel())
    fresh = upd.init_state(n, 1, dev)
    kept = all(torch.equal(getattr(s3, name), getattr(fresh, name))
               for name in LEAVES)
    # the payload's add_cnt is a normal draw, so counts walk below the
    # V gate (cnt >= 0) as the series goes: a card's traffic follows them
    rows = uids[pay[2 + k] > 0].long()
    print(f"touched rows past the V gate after the series: "
          f"{int((s1.cnt[rows] >= 0).sum())} of {touched}", flush=True)
    if dev.type == "cuda":
        works = {name: upd.init_state(n, 1, dev) for name in ("b2", "new")}
        calls = {"apply_pairs": lambda: pair_sweep.apply_pairs(
            works["b2"], uids, pay, p)}
        for stage in pair_sweep.PLANAR_APPLY_STAGES:
            calls[stage] = lambda stage=stage: pair_sweep.apply_pairs2(
                works["new"], uids, pay, p, stage)
        own = common.kernel_ms_in_turns(dev, calls, (
            "apply_pairs_kernel", "planar_apply_kernel"))
        print(f"kernel ms in turns (apply_pairs2 by stage word): {own}",
              flush=True)
    print(f"max |final state difference| {diff:.3e}; rmwonly kept the "
          f"state's bits: {kept}", flush=True)
    # one function, the same sums in the same order: they agree to the
    # last bit on the card, and are one plain version on the CPU
    return 0 if diff <= 1e-5 and kept else 1

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
