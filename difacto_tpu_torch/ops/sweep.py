"""Whole-table sweep access to the parameter table: pull and fused apply
(``kernel=pallas``).

Port of ``difacto_tpu/ops/sweep.py``: the single-stream interface of the
sweep kernels of ops/sweep_ms.py (B4, B5). The batch's unique ids are
sorted (host prep guarantees it), so the ids of table block ``b`` form
one contiguous slice; the per-block slice offsets are one
``searchsorted`` outside the kernels.

``state`` is a planar FMState (w/z/n/cnt [N], V/nV [K, N]) or a
row-major PackedFMState (``layout=packed``): the wrappers of
ops/sweep_ms.py pick the kernel by the state's type. ``block_rows`` must
divide N. K = 0 (sparse LR) carries no V.
"""

from __future__ import annotations

import torch

from ..config import FMParam
from .sweep_ms import apply_payload, sweep_apply_ms, sweep_pull_ms


def offsets_1(sid: torch.Tensor, num_rows: int,
              block_rows: int) -> torch.Tensor:
    """i32 [1, N/block_rows + 1]: the block boundaries of one sorted
    stream."""
    nb = num_rows // block_rows
    bounds = torch.arange(nb + 1, dtype=sid.dtype, device=sid.device)
    return torch.searchsorted(sid, bounds * block_rows, side="left",
                              out_int32=True)[None, :]


def _sid(uids: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(valid, uids, n).to(torch.int32)


def sweep_pull(state, uids: torch.Tensor, valid: torch.Tensor,
               param: FMParam, *, block_rows: int = 1024) -> torch.Tensor:
    """Rows [U, 1+K] for sorted unique ids (sentinel-padded): w, and V
    gated by ``cnt >= V_threshold``; invalid lanes zero."""
    n = state.num_rows
    sid = _sid(uids, valid, n)
    rows_p = sweep_pull_ms(state, sid, offsets_1(sid, n, block_rows), param,
                           block_rows=block_rows)
    return torch.where(valid[:, None], rows_p.T, 0.0)


def sweep_apply(state, uids: torch.Tensor, grads: torch.Tensor,
                add_cnt: torch.Tensor, valid: torch.Tensor, param: FMParam,
                *, block_rows: int = 1024):
    """Fused optimizer apply, in place. ``grads`` are the per-key
    gradients PLANAR [1+K, U] (the transpose of the JAX function's
    ``[U, 1+K]``, and the layout of the apply payload, so the sorted
    backward's output goes straight in); ``add_cnt`` [U]."""
    n = state.num_rows
    sid = _sid(uids, valid, n)
    return sweep_apply_ms(state, sid, apply_payload(grads, add_cnt, valid),
                          offsets_1(sid, n, block_rows), param,
                          block_rows=block_rows)
