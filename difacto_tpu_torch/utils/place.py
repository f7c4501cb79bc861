"""Device placement of host batch dataclasses.

Port of ``difacto_tpu/utils/place.py``. The learner calls it in a
prefetch thread, one batch ahead of the step that consumes it, so the
host-to-device copy of batch t+1 overlaps the kernels of batch t. It
places prepped batches (their sorted slots and, for the hot/cold split,
both buckets) and, with ``host_localize=0``, raw batches, which the store
localizes on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _to(v, device: torch.device):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return None


def place_batch(b, device: torch.device):
    """A copy of a batch dataclass (Batch / PreppedBatch) with every NumPy
    array or tensor field on ``device``, including the arrays inside one
    level of nested dataclass fields (the sorted slots). Other fields pass
    through; a batch already on ``device`` comes back unchanged."""
    top: dict[str, object] = {}
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            sub = {g.name: _to(getattr(v, g.name), device)
                   for g in dataclasses.fields(v)}
            sub = {k: t for k, t in sub.items()
                   if t is not None and t is not getattr(v, k)}
            if sub:
                top[f.name] = dataclasses.replace(v, **sub)
            continue
        t = _to(v, device)
        if t is not None and t is not v:
            top[f.name] = t
    return dataclasses.replace(b, **top) if top else b
