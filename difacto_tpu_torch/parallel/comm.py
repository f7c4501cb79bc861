"""The collectives of the sharded store's per-rank program.

The JAX ShardedStore runs one program per device inside ``shard_map`` and
calls three collectives over the mesh axis ``shard``
(``difacto_tpu/parallel/store.py``): ``jax.lax.all_to_all(...,
tiled=True)`` with equal splits, ``psum`` and ``axis_index``. Here one
process (a rank of a ``torch.distributed`` group) holds one shard, and
the same three are

  all_to_all   ``torch.distributed.all_to_all_single`` with equal splits;
  all_reduce   ``torch.distributed.all_reduce(SUM)``;
  rank         the rank in the group;

plus an all-gather, which the JAX package gets from a global array's
``device_get`` (the whole table on the host for a checkpoint, the scores
of an eval step).

:func:`allgather_host` is the multi-process learner's
``multihost_utils.process_allgather``: a small NumPy array from every
process of the default group, as CPU tensors (the lockstep's "have data"
flag, the agreed all_to_all capacity, the exact AUC's pairs, BCD's build
shapes), so none of them waits on the card. Every process calls it at
the same point of its program, on its main thread.

With no process group (or a group of one) a :class:`Comm` has S = 1 and
every collective is the identity: the store's S = 1 branch calls none.

The transport is the group's, fixed by how the run was launched, and
there is no switch between transports here: gloo on CPU tensors (the CPU
tests) or gloo on CUDA tensors for several ranks that share one card.
PyTorch's gloo group takes CUDA tensors in all four calls and stages
them through host memory itself (torch 2.11 on an NVIDIA H100 80GB HBM3,
700 W, checked with 2 and 3 ranks on the card; ``chip_smoke.py`` P8
prints the exchange's share of the step). NCCL, one rank a card, is
ROADMAP A9c; these calls do not change for it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tracing import span
from .multihost import process_count


def allgather_host(x) -> np.ndarray:
    """[P, *x.shape]: every process's NumPy array ``x`` (the same shape and
    dtype on every process), in rank order; ``x[None]`` without a group."""
    x = np.ascontiguousarray(x)
    if not (dist.is_available() and dist.is_initialized()) or (
            dist.get_world_size() == 1):
        return x[None]
    t = torch.from_numpy(x.copy())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    with span("difacto.exchange"):
        dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_pairs(y: np.ndarray, p: np.ndarray):
    """(label, score) pairs of every process, in process order (JAX
    ``SGDLearner._allgather_pairs``): each pads to the longest with label
    NaN, which no real label is (a sign test would drop genuine
    negatives). One process (no multi-process launch): the pairs as
    given."""
    if process_count() == 1:
        return y, p
    m = int(allgather_host(np.array(len(y), np.int64)).max())
    ypad = np.full(m, np.nan, np.float32)
    ppad = np.zeros(m, np.float32)
    ypad[:len(y)] = y
    ppad[:len(p)] = p
    yg = allgather_host(ypad).reshape(-1)
    pg = allgather_host(ppad).reshape(-1)
    keep = ~np.isnan(yg)
    return yg[keep], pg[keep]


class Comm:
    """The group a ShardedStore shards over: the initialized default
    group, if any. ``size`` is S, ``rank`` this process's shard."""

    def __init__(self):
        if dist.is_available() and dist.is_initialized():
            self.size, self.rank = dist.get_world_size(), dist.get_rank()
        else:
            self.size, self.rank = 1, 0

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [S*C, ...]: block s (rows s*C .. s*C+C) goes to rank s;
        returns [S*C, ...] whose block s came from rank s (the tiled
        ``all_to_all`` with ``split_axis = concat_axis = 0``)."""
        if self.size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        with span("difacto.exchange"):
            dist.all_to_all_single(out, x)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (``psum``), in place; returns ``x``."""
        if self.size > 1:
            with span("difacto.exchange"):
                dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[S, *x.shape]: every rank's ``x``, in rank order."""
        if self.size == 1:
            return x[None]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        with span("difacto.exchange"):
            dist.all_gather(out, x)
        return torch.stack(out)
