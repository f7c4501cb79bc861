"""The localized-batch tuple (port of ``difacto_tpu/ops/localize.py``'s
``Localized``). Device-side localization (``host_localize=0``) waits for
ROADMAP A16; the port's batches are localized on the host
(data/prep.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Localized(NamedTuple):
    uids: torch.Tensor    # i32 [U] unique table indices, sorted ascending;
                          #         invalid lanes hold the sentinel num_rows
    inv: torch.Tensor     # i32 [B*L] position of each nnz slot in uids
    counts: torch.Tensor  # f32 [U] multiplicity of each unique id (0 for invalid)
    valid: torch.Tensor   # bool [U] real id (not unique-padding / input-padding)
