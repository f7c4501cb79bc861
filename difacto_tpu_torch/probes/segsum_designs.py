"""The segment sum's three designs, timed in turns on one payload.

``segsum_sorted`` (ops/segsum.py) has been written three times for the
card: ``chunks`` (``segsum_sorted_chunks``, csrc/segsum.cu, a warp per
payload row and 512-slot chunk), ``tiles`` (``segsum_sorted``,
csrc/segsum_tiles.cu, a warp per slot tile for all payload rows: the one
the training paths run) and ``rows`` (``segsum_sorted_rows``, the same
sums from a row-major payload, a thread per tile and column as
csrc/slot_accum.cu). This probe makes the flagship's backward payload
shape (2 + K = 18 rows over one batch's sorted slots, Zipf lanes with one
hot key), checks that the three agree (exactly, on an integer payload,
with each other and with ``index_add_``) and prints each design's kernel
time, taken in the order chunks, tiles, rows and back, with the L2 warm
and flushed, then each design's time by kernel (its passes and its
memset).

    python -m difacto_tpu_torch.probes.segsum_designs

``batch=``, ``nnz=``, ``num_bits=`` and ``pp=`` shrink the shapes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..data.prep import build_sorted_slots, prep_batch
from ..ops import segsum
from . import common


def designs(payT: torch.Tensor, pay: torch.Tensor, lanes: torch.Tensor,
            ub: int) -> dict:
    """name -> a call of that design on the payload (planar ``payT`` or
    its row-major copy ``pay``)."""
    return {"chunks": lambda: segsum.segsum_sorted_chunks(payT, lanes, ub),
            "tiles": lambda: segsum.segsum_sorted(payT, lanes, ub),
            "rows": lambda: segsum.segsum_sorted_rows(pay, lanes, ub)}


def main(argv=None, device=None) -> int:
    _, o = common.parse_args(argv, dict(batch=common.BATCH, nnz=common.NNZ,
                                        num_bits=common.NUM_BITS,
                                        pp=2 + common.K))
    dev = common.start("segsum_designs", device)
    pb = prep_batch(common.flagship_batch(0, o["batch"], o["nnz"],
                                          o["num_bits"]), 1 << o["num_bits"])
    ss = build_sorted_slots(pb.inv, pb.vals)
    lanes = torch.from_numpy(np.ascontiguousarray(ss.inv_sorted)).to(dev)
    ub, blp, pp = pb.uids.shape[0], lanes.shape[0], o["pp"]
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    real = o["batch"] * o["nnz"]
    ipayT = torch.randint(1, 9, (pp, blp), generator=g, device=dev).float()
    ipayT[:, real:] = 0.0
    want = segsum.segsum_sorted_plain(ipayT, lanes, ub)
    calls = designs(ipayT, ipayT.T.contiguous(), lanes, ub)
    wrong = [name for name, fn in calls.items()
             if not torch.equal(fn(), want)]
    print(f"{pp} rows x {blp} slots into {ub} lanes, hottest lane "
          f"{int(torch.bincount(lanes.long()).max())} slots; integer payload "
          f"exact: {'all designs' if not wrong else 'NOT ' + str(wrong)}",
          flush=True)
    payT = torch.randn((pp, blp), generator=g, device=dev)
    payT[:, real:] = 0.0
    calls = designs(payT, payT.T.contiguous(), lanes, ub)
    if dev.type == "cuda":
        # each design's kernels and its memset
        turns = common.kernel_ms_in_turns(dev, calls, ("segsum", "Memset"))
        for label, ms in (("warm", turns["warm"]), ("flushed", turns["cold"])):
            print(f"kernel time, L2 {label} (ms): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                  flush=True)
        for name, fn in calls.items():  # where each design's time goes
            parts = {k.split("(")[0].removeprefix("void "): v
                     for k, v in common.kernel_times(fn).items()}
            print(f"{name}, L2 warm, by kernel (ms): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()),
                  flush=True)
    else:
        print("kernel time: " + common.fmt_ms(None), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
