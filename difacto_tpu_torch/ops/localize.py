"""Per-batch feature-id deduplication on the device (``host_localize=0``).

Port of ``difacto_tpu/ops/localize.py`` (reference:
``src/data/localizer.h`` :: Localizer::Compact — sort and dedup the
minibatch's ids, rewrite each slot to its position in the unique list,
count each id). In the JAX package this is XLA, not a Pallas kernel; here
it is PyTorch tensor ops with a static output size:

  * ids are i32 with PAD_ID = -1; pads map to the sentinel ``num_rows``,
    which sorts after every real id, so pads and unique padding share the
    tail;
  * when the batch holds more distinct real ids than ``unique_size``, the
    excess ids are dropped from the unique set and their slots alias the
    last lane, ``unique_size - 1``: training is wrong for that lane, which
    is why the drop is COUNTED (``Localized.overflow``, surfaced as
    ``StepMetrics.dropped_ids``).

The host path (data/prep.py) localizes in the prep workers instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Localized(NamedTuple):
    uids: torch.Tensor    # i32 [U] unique table indices, sorted ascending;
                          #         invalid lanes hold the sentinel num_rows
    inv: torch.Tensor     # i32 [B*L] position of each nnz slot in uids
    counts: torch.Tensor  # f32 [U] multiplicity of each unique id (0 for invalid)
    valid: torch.Tensor   # bool [U] real id (not unique-padding / input-padding)
    overflow: torch.Tensor | None = None  # f32 [] distinct real ids dropped
                          #         because unique_size was too small
                          #         (None on host-prepped batches)


def localize(ids: torch.Tensor, num_rows: int, unique_size: int) -> Localized:
    """ids: i32 [B, L] (PAD_ID = -1). ``unique_size`` should be at least
    the number of distinct ids in the batch (B*L always is); past it ids
    are dropped and counted. The same five arrays as the JAX function,
    bit for bit: a stable sort, first-of-run flags, a cumsum for the
    lanes, and lane scatters whose drop rule (lanes >= U go nowhere) is
    a spare last slot cut off after."""
    flat = ids.reshape(-1).to(torch.int32)
    U = unique_size
    keys = torch.where(flat < 0, num_rows, flat).to(torch.int32)
    sk, order = torch.sort(keys, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    lane = torch.cumsum(first, 0) - 1  # 0-based unique lane of each slot
    real = sk < num_rows
    overflow = (first & real & (lane >= U)).to(torch.float32).sum()
    drop = lane.clamp(max=U)  # lane U: the spare slot, cut off below
    # every write to one lane carries the same id: deterministic
    uids = torch.full((U + 1,), num_rows, dtype=torch.int32,
                      device=flat.device)
    uids.scatter_(0, drop, sk)
    counts = torch.zeros(U + 1, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, drop, real.to(torch.float32))
    inv = torch.empty_like(flat)
    inv[order] = lane.clamp(max=U - 1).to(torch.int32)
    uids, counts = uids[:U], counts[:U]
    return Localized(uids, inv, counts, uids < num_rows, overflow)
