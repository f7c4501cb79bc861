"""Sorted-slot segment sum: per-key gradient aggregation with no scatter.

Port of ``difacto_tpu/ops/segsum.py::segsum_sorted``. The host prep
already sorts the batch's slots by unique lane (data/prep.py), so per-key
sums are segment sums over a monotone lane stream. The TPU kernel cut the
stream into (tile, window) incidences and contracted each with a one-hot
matmul, from a host-built schedule; the Hopper kernels need no schedule:
they split the stream by slots and combine the pieces of segments that
cross tile boundaries in a second pass, which keeps a power-law hot key
from serialising on one thread.

Three designs compute the function:

* :func:`segsum_sorted` (csrc/segsum_tiles.cu), the one every path runs:
  a warp owns a tile of slots for all payload rows, reads the lanes once
  and works out the segment structure once;
* :func:`segsum_sorted_chunks` (csrc/segsum.cu), the first design, a warp
  per (payload row, 512-slot chunk): the yardstick the new one is timed
  against;
* :func:`segsum_sorted_rows` (csrc/segsum_tiles.cu), the same sums from a
  ROW-MAJOR payload ``[BLp, pp]``, a thread per (tile, column) as
  csrc/slot_accum.cu: the candidate that lost on the card (PERF.md,
  section 6).

No path of the package calls the last two: probes/segsum_designs.py times
the three in turns. Each is a wrapper: a CUDA tensor launches the kernel,
a CPU tensor takes the plain version (``index_add_`` into zeros).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda

TILE_SLOTS = 1024   # stream padding granule (kept from the JAX package so
                    # both packages see the same padded arrays)
CHUNK = 512         # slots per pass-1 warp in csrc/segsum.cu
TILE = 128          # slots per pass-1 warp in csrc/segsum_tiles.cu, and
                    # per tile of its row-major entry
ROWS_MAX_COLS = 256  # payload columns the row-major design takes


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


def _scratch(pp: int, nt: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tile's first and last piece, per payload row."""
    return (torch.empty((nt, pp), dtype=torch.float32, device=dev),
            torch.empty((nt, pp), dtype=torch.float32, device=dev))


def _check(payT, lanes):
    pp, blp = payT.shape
    cuda.require(payT, "payT", torch.float32, (pp, blp), payT.device)
    cuda.require(lanes, "lanes", torch.int32, (blp,), payT.device)
    return pp, blp, payT.device


def segsum_sorted(payT: torch.Tensor, lanes: torch.Tensor,
                  ub: int) -> torch.Tensor:
    """Per-lane segment sums [pp, ub] of a planar slot payload
    ``payT [pp, BLp]`` in sorted-slot order; ``lanes [BLp]`` (i32) is
    monotone with values in [0, ub). Lanes no slot touches are exactly 0."""
    if payT.device.type == "cpu":
        return segsum_sorted_plain(payT, lanes, ub)
    pp, blp, dev = _check(payT, lanes)
    out = torch.empty((pp, ub), dtype=torch.float32, device=dev)
    head, tail = _scratch(pp, -(-blp // TILE), dev)
    rc = cuda.library().dft_segsum_tiles(
        payT.data_ptr(), lanes.data_ptr(), out.data_ptr(), head.data_ptr(),
        tail.data_ptr(), pp, blp, ub, cuda.stream(dev))
    cuda.check(rc, "segsum_tiles")
    cuda.LAUNCHES["segsum_sorted"] += 1
    return out


def segsum_sorted_chunks(payT: torch.Tensor, lanes: torch.Tensor,
                         ub: int) -> torch.Tensor:
    """:func:`segsum_sorted` by the first design (csrc/segsum.cu). No path
    of the package calls it."""
    if payT.device.type == "cpu":
        return segsum_sorted_plain(payT, lanes, ub)
    pp, blp, dev = _check(payT, lanes)
    out = torch.empty((pp, ub), dtype=torch.float32, device=dev)
    nch = (blp + CHUNK - 1) // CHUNK
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
    cuda.check(rc, "segsum_chunks")
    cuda.LAUNCHES["segsum_chunks"] += 1
    return out


def segsum_sorted_rows_plain(pay: torch.Tensor, lanes: torch.Tensor,
                             ub: int) -> torch.Tensor:
    out = pay.new_zeros((ub, pay.shape[1]))
    return out.index_add_(0, lanes.long(), pay).T.contiguous()


def segsum_sorted_rows(pay: torch.Tensor, lanes: torch.Tensor,
                       ub: int) -> torch.Tensor:
    """:func:`segsum_sorted` from a ROW-MAJOR payload ``pay [BLp, pp]``
    (a slot's values contiguous; pp <= ``ROWS_MAX_COLS``): the same planar
    sums ``[pp, ub]``. No path of the package calls it."""
    if pay.device.type == "cpu":
        return segsum_sorted_rows_plain(pay, lanes, ub)
    blp, pp = pay.shape
    dev = pay.device
    cuda.require(pay, "pay", torch.float32, (blp, pp), dev)
    cuda.require(lanes, "lanes", torch.int32, (blp,), dev)
    if pp > ROWS_MAX_COLS:
        raise ValueError(f"segsum_sorted_rows takes at most {ROWS_MAX_COLS} "
                         f"payload columns, got {pp}")
    out = torch.empty((pp, ub), dtype=torch.float32, device=dev)
    head, tail = _scratch(pp, -(-blp // TILE), dev)
    rc = cuda.library().dft_segsum_rows(
        pay.data_ptr(), lanes.data_ptr(), out.data_ptr(), head.data_ptr(),
        tail.data_ptr(), pp, blp, ub, cuda.stream(dev))
    cuda.check(rc, "segsum_rows")
    cuda.LAUNCHES["segsum_rows"] += 1
    return out
