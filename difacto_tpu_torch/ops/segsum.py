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

* :func:`segsum_sorted` (csrc/segsum_tiles.cu), the one FFM's and K = 0's
  paths run:
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
the three in turns.

FM with K > 0 does not call them: :func:`segsum_fm` (csrc/segsum_tiles.cu,
``fm_keysum_kernel`` and ``fm_keysum_join``) is B3's tile design with the
payload built inside the kernel. Its 2 + K rows (dw = d x, dw x, dw S_k)
are formed in registers from the sorted stream, ``d`` and the forward's
``S``, and the per-key combine against the pulled rows is folded into the
writes. The result is the planar [1 + K, U] gradient. No [2 + K, BLp]
payload and no [2 + K, U] sums reach device memory, with the same bits
as the composition it replaces (:func:`segsum_fm_plain`).

Each is a wrapper: a CUDA tensor launches the kernel, a CPU tensor takes
the plain version (``index_add_`` into zeros; for :func:`segsum_fm` the
composition, B3 included).
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


def segsum_fm_plain(d: torch.Tensor, S: torch.Tensor, x_s: torch.Tensor,
                    bidx: torch.Tensor, lanes: torch.Tensor,
                    rows_u: torch.Tensor) -> torch.Tensor:
    """FM's per-key gradients by composition: the 2 + K row payload
    gathered and multiplied out in sorted-slot order, :func:`segsum_sorted`
    over it, then the combine ``gV = sum dw S - V sum dw x``. On a CUDA
    tensor its segment sum is B3: the yardstick of :func:`segsum_fm`."""
    dS = torch.cat([d[:, None], S], dim=1)                # [B, 1+K]
    g = dS.index_select(0, bidx)                          # [BLp, 1+K]
    dw_s = g[:, 0] * x_s
    payT = torch.cat([dw_s[None, :], (dw_s * x_s)[None, :],
                      (dw_s[:, None] * g[:, 1:]).T], dim=0)
    segs = segsum_sorted(payT.contiguous(), lanes, rows_u.shape[0])
    gV = segs[2:] - rows_u.T[1:] * segs[1][None, :]
    return torch.cat([segs[:1], gV], dim=0)


def segsum_fm(d: torch.Tensor, S: torch.Tensor, x_s: torch.Tensor,
              bidx: torch.Tensor, lanes: torch.Tensor,
              rows_u: torch.Tensor) -> torch.Tensor:
    """FM's planar per-key gradients [1 + K, U] from the sorted stream:
    ``d`` [B] the loss's d l/d py, ``S`` [B, K] the forward's sum of x V,
    ``x_s``, ``bidx`` (i32), ``lanes`` (i32, monotone) [BLp] in sorted-slot
    order, ``rows_u`` [U, 1 + K] the pulled rows (any strides). Row 0 is
    sum dw, row 1 + k sum dw S_k - V[u, 1 + k] sum dw x, with dw = d[b] x;
    lanes no slot touches are exactly 0. The same bits as
    :func:`segsum_fm_plain`, which a CPU tensor takes."""
    if d.device.type == "cpu":
        return segsum_fm_plain(d, S, x_s, bidx, lanes, rows_u)
    K = S.shape[1]
    B, blp, ub, dev = d.shape[0], lanes.shape[0], rows_u.shape[0], d.device
    cuda.require(d, "d", torch.float32, (B,), dev)
    cuda.require(S, "S", torch.float32, (B, K), dev)
    cuda.require(x_s, "x_s", torch.float32, (blp,), dev)
    cuda.require(bidx, "bidx", torch.int32, (blp,), dev)
    cuda.require(lanes, "lanes", torch.int32, (blp,), dev)
    if (rows_u.device != dev or rows_u.dtype != torch.float32
            or tuple(rows_u.shape) != (ub, 1 + K)):
        raise ValueError(f"rows_u must be f32 [{ub}, {1 + K}] on {dev}, got "
                         f"{rows_u.dtype} {tuple(rows_u.shape)} on "
                         f"{rows_u.device}")
    out = torch.empty((1 + K, ub), dtype=torch.float32, device=dev)
    head, tail = _scratch(2 + K, -(-blp // TILE), dev)
    rc = cuda.library().dft_segsum_fm(
        d.data_ptr(), S.data_ptr(), x_s.data_ptr(), bidx.data_ptr(),
        lanes.data_ptr(), rows_u.data_ptr(), rows_u.stride(0),
        rows_u.stride(1), out.data_ptr(), head.data_ptr(), tail.data_ptr(),
        K, blp, ub, cuda.stream(dev))
    cuda.check(rc, "segsum_fm")
    cuda.LAUNCHES["segsum_fm"] += 1
    return out
