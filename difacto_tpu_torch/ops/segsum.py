"""Sorted-slot segment sum: per-key gradient aggregation with no scatter.

Port of ``difacto_tpu/ops/segsum.py::segsum_sorted``. The host prep
already sorts the batch's slots by unique lane (data/prep.py), so per-key
sums are segment sums over a monotone lane stream. The TPU kernel cut the
stream into (tile, window) incidences and contracted each with a one-hot
matmul, from a host-built schedule; the Hopper kernel (csrc/segsum.cu)
needs no schedule — it splits the stream by slots and combines the pieces
of segments that cross chunk boundaries in a second pass, which keeps a
power-law hot key from serialising on one thread.

``segsum_sorted`` is a wrapper: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version (``index_add_`` into zeros).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda

TILE_SLOTS = 1024   # stream padding granule (kept from the JAX package so
                    # both packages see the same padded arrays)
CHUNK = 512         # slots per pass-1 warp in csrc/segsum.cu


def pad_sorted_stream(inv_sorted: np.ndarray, tile_slots: int = TILE_SLOTS):
    """Pad a monotone lane stream to a tile multiple by repeating the
    last lane (pad slots must carry zero payload). Copy of
    ``difacto_tpu/ops/segsum.py::pad_sorted_stream``."""
    bl = inv_sorted.shape[0]
    blp = (bl + tile_slots - 1) // tile_slots * tile_slots
    if blp == bl:
        return inv_sorted.astype(np.int32, copy=False)
    last = inv_sorted[-1] if bl else 0
    return np.concatenate(
        [inv_sorted.astype(np.int32, copy=False),
         np.full(blp - bl, last, np.int32)]
    )


def segsum_sorted_plain(payT: torch.Tensor, lanes: torch.Tensor,
                        ub: int) -> torch.Tensor:
    out = payT.new_zeros((payT.shape[0], ub))
    out.index_add_(1, lanes.long(), payT)
    return out


def segsum_sorted(payT: torch.Tensor, lanes: torch.Tensor,
                  ub: int) -> torch.Tensor:
    """Per-lane segment sums [pp, ub] of a planar slot payload
    ``payT [pp, BLp]`` in sorted-slot order; ``lanes [BLp]`` (i32) is
    monotone with values in [0, ub). Lanes no slot touches are exactly 0."""
    if payT.device.type == "cpu":
        return segsum_sorted_plain(payT, lanes, ub)
    pp, blp = payT.shape
    dev = payT.device
    cuda.require(payT, "payT", torch.float32, (pp, blp), dev)
    cuda.require(lanes, "lanes", torch.int32, (blp,), dev)
    nch = (blp + CHUNK - 1) // CHUNK
    out = torch.empty((pp, ub), dtype=torch.float32, device=dev)
    # scratch: per-chunk boundary pieces and per-lane segment bounds
    head = torch.empty((pp, nch), dtype=torch.float32, device=dev)
    tail = torch.empty((pp, nch), dtype=torch.float32, device=dev)
    seg_lo = torch.empty(ub, dtype=torch.int32, device=dev)
    seg_hi = torch.empty(ub, dtype=torch.int32, device=dev)
    rc = cuda.library().dft_segsum_sorted(
        payT.data_ptr(), lanes.data_ptr(), out.data_ptr(), head.data_ptr(),
        tail.data_ptr(), seg_lo.data_ptr(), seg_hi.data_ptr(), pp, blp, ub,
        cuda.stream(dev),
    )
    cuda.check(rc, "segsum_sorted")
    cuda.LAUNCHES["segsum_sorted"] += 1
    return out
