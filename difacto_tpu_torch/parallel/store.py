"""Parameter store: one table on one device.

Port of ``difacto_tpu/parallel/store.py`` :: LocalStore (reference:
``src/store/store_local.h`` :: StoreLocal, which calls the updater in
process). A train step is

    pull -> [B, L] forward -> backward -> per-key sums -> apply, in place,

and an eval step is pull -> forward. The config picks the table kernels
and the per-key aggregation, as the JAX store does
(``store.py:243-249``, ``:626-689``):

* ``kernel=auto|pairs``: pull and apply of the batch's unique rows
  (ops/pair_sweep.py, B1, B2), over planar leaves (``layout=planar``) or
  over the row-major table (``layout=packed``, csrc/rowmajor_pairs.cu);
* ``kernel=pallas``: the whole-table sweep (ops/sweep.py, B4, B5), over
  either layout too (``layout=packed``: csrc/rowmajor_sweep.cu);
* ``segsum=sorted``: the sorted-slot backward and the segment-sum kernel
  (learners/step.py::worker_grads_sorted, B3); ``segsum=scatter``: the
  ``index_add_`` backward (worker_grads); ``segsum=auto``: sorted for
  pairs, scatter for pallas.

Both take the host-prepped batch (data/prep.py) and run the hand-written
kernels when the state lies on the card, their plain versions when it
lies on the CPU. ``loss=ffm`` runs every path with rows of 1 + F*k
floats (``Config.effective_model_param``) and the FFM math of
learners/step.py (JAX ``store.py:227-230``); with ``num_fields`` > 0
(libffm) every path reads the batch's explicit fields, validated on the
host. The sharded store waits (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data.prep import PreppedBatch, build_sorted_slots, validate_fields
from ..learners.step import (StepMetrics, worker_forward, worker_grads,
                             worker_grads_sorted)
from ..ops.localize import Localized
from ..ops.pair_sweep import apply_pairs, pull_pairs
from ..ops.sweep import sweep_apply, sweep_pull
from ..ops.sweep_ms import apply_payload
from ..updaters.updater import (FMState, FMUpdater, LEAVES, PackedFMState,
                                pack_state, unpack_state)
from ..utils.device import resolve_device
from ..utils.place import place_batch


def _require_fields(fields, num_fields: int):
    """Validate explicit libffm fields: present, and in [0, num_fields)
    (the loss clips field ids into range, so an out-of-range id —
    num_fields set too small, or a malformed file — would otherwise train
    a silently wrong model). One implementation, data/prep.py's, which
    the prep workers run too; a placed batch that skipped it is checked
    on a host copy."""
    if isinstance(fields, torch.Tensor):
        validate_fields(fields.cpu().numpy(), num_fields)
    else:
        validate_fields(fields, num_fields)
    return fields


def _prepped_fields(pb: PreppedBatch, num_fields: int):
    """Fields of a prepped batch, skipping the O(B*L) range re-check when
    prep already validated them (the JAX store's one skip rule)."""
    if pb.fields_checked and pb.fields is not None:
        return pb.fields
    return _require_fields(pb.fields, num_fields)


def _resolve_layout(cfg: Config) -> str:
    """planar = one array per leaf with V [K, N]; packed = one row-major
    [N, 4+2K] table, which the kernels of csrc/rowmajor_pairs.cu and
    csrc/rowmajor_sweep.cu read and write in a fifth of the 32-byte
    sectors. Both table paths take both layouts. The JAX store refuses
    packed with its table kernels because XLA pads a 36-wide minor
    dimension to 128 lanes: a TPU mechanism that does not exist here.
    ``stacked`` is refused by the config (ROADMAP A14).

    ``auto`` follows what was measured on an H100 (PERF.md, section 6)
    and moves nobody onto a kernel that is slower. With factors
    (V_dim > 0) every row-major kernel, pairs and sweep, is faster than
    its planar counterpart for every updater pair, with the L2 warm and
    cold, at K = 16 and at FFM's K = F*k = 96 alike: packed. Without factors the row-major sweep kernels and the pair
    apply are faster too, but the pair pull reads w out of a table four
    times the size of the planar w and is slower with the L2 cold: packed
    on ``kernel=pallas``, planar on the pairs path."""
    lay = cfg.shard.layout
    if lay == "auto":
        packed = cfg.model.V_dim > 0 or cfg.shard.kernel == "pallas"
        return "packed" if packed else "planar"
    if lay not in ("packed", "planar", "stacked"):
        raise ValueError(f"layout must be auto|packed|planar|stacked, "
                         f"got {lay!r}")
    return lay


class LocalStore:
    """Single-device store (reference: StoreLocal + local Tracker).

    ``device`` defaults to the card; without one it raises unless the
    caller asks for ``"cpu"`` (utils/device.py). The state's tensors are
    updated IN PLACE by every train step: the step returns the same
    state object it was given (an FMState, or with ``layout=packed`` a
    PackedFMState)."""

    def __init__(self, updater: FMUpdater, cfg: Config, device=None):
        self.updater = updater
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_rows = 1 << cfg.data.num_bits
        self.param = updater.param
        width = cfg.effective_model_param().V_dim
        if self.param.V_dim != width:
            raise ValueError(
                f"the updater's V_dim {self.param.V_dim} is not the config's "
                f"factor width {width} (Config.effective_model_param: F*k "
                "for loss=ffm)")
        # the loss and its keywords for learners/step.py
        self.loss = cfg.learner.loss
        self.num_fields = cfg.model.num_fields
        self.loss_kw = dict(loss=self.loss, num_fields=self.num_fields,
                            ffm_block=cfg.model.ffm_block_size)
        # libffm explicit fields: batches carry an i32 [B, L] field array
        self.expects_fields = cfg.expects_fields()
        s = cfg.shard
        self.pallas = s.kernel == "pallas"
        self.layout = _resolve_layout(cfg)
        self.block_rows = min(s.block_rows, self.num_rows)
        # segsum=auto: the sorted backward on pairs, scatter on pallas
        self.sorted_grads = s.segsum == "sorted" or (
            s.segsum == "auto" and not self.pallas)

    def init_state(self, seed: int = 0):
        init = (self.updater.init_state_packed if self.layout == "packed"
                else self.updater.init_state)
        return init(self.num_rows, seed, self.device)

    def place_state(self, host_state):
        """Move a host state of either layout onto this store's device,
        in this store's layout. A single-file checkpoint from a padded
        sharded run carries more rows than the hash space; the extra rows
        must be zero and are cut off."""
        n_in = host_state.num_rows
        if n_in > self.num_rows:
            if bool((host_state.w[self.num_rows:] != 0).any()):
                raise ValueError(
                    f"checkpoint has {n_in} rows with nonzero weights past "
                    f"this store's {self.num_rows}-row hash space — was it "
                    f"saved with a larger num_bits?"
                )
        elif n_in < self.num_rows:
            raise ValueError(
                f"checkpoint has {n_in} rows but this store's hash space "
                f"is {self.num_rows} (num_bits mismatch — retrain or load "
                f"with the original num_bits)"
            )
        k = self.param.V_dim
        if host_state.k != k:
            raise ValueError(f"checkpoint has V_dim {host_state.k} but this "
                             f"store expects {k} (F*k for loss=ffm)")
        packed_in = isinstance(host_state, PackedFMState)
        if packed_in:
            tbl = host_state.tbl[: self.num_rows]
            placed = PackedFMState(
                tbl=tbl.to(self.device, torch.float32).contiguous())
        else:
            leaves = {}
            for name in LEAVES:
                t = getattr(host_state, name)[..., : self.num_rows]
                leaves[name] = t.to(self.device, torch.float32).contiguous()
            placed = FMState(**leaves)
        if packed_in == (self.layout == "packed"):
            return placed
        return pack_state(placed) if self.layout == "packed" else (
            unpack_state(placed))

    def shard_batch(self, ids, vals, labels, mask, fields=None):
        """A raw batch's arrays for a step, with its fields validated
        when the config declares them (JAX ``store.py:379-382``)."""
        if self.expects_fields:
            return ids, vals, labels, mask, _require_fields(
                fields, self.num_fields)
        return ids, vals, labels, mask

    def count_step(self, state, ids):
        """Feature-frequency pass, in place (reference: Store::kFeaCount
        push used for tail filtering before training)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        return self.updater.add_counts(state, ids)

    def _placed(self, pb: PreppedBatch, need_slots: bool) -> PreppedBatch:
        """The batch as tensors on this store's device. Host batches get
        their sorted slots built here when the prep workers did not
        (kept on the batch, so replayed batches reuse them); FFM's also
        keep the sort permutation. Explicit fields are checked first
        (on the host array, when the batch is still there) unless the
        prep did."""
        if self.expects_fields:
            pb.fields = _prepped_fields(pb, self.num_fields)
            pb.fields_checked = True
        ffm = self.loss == "ffm"
        ss = pb.sorted_slots
        if need_slots and (ss is None or (ffm and ss.slot_sorted is None)):
            if isinstance(pb.inv, torch.Tensor):
                raise ValueError("a placed batch needs its sorted slots "
                                 "built before placement (data/prep.py)")
            pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals,
                                                 with_slots=ffm)
        return place_batch(pb, self.device)

    def _fields(self, pb: PreppedBatch):
        """The placed batch's fields for the loss: None unless the config
        declares them (then FFM's field is the slot position)."""
        return pb.fields if self.expects_fields else None

    def _pull(self, state, pb: PreppedBatch) -> torch.Tensor:
        """Unique rows [U, 1+K] (w | count-gated V) of the batch. Lanes
        past the batch's real unique count are zero (the valid mask)."""
        if self.pallas:
            return sweep_pull(state, pb.uids, pb.valid, self.param,
                              block_rows=self.block_rows)
        rows_p = pull_pairs(state, pb.uids, self.param)
        return torch.where(pb.valid[:, None], rows_p.T, 0.0)

    def _apply(self, state, pb: PreppedBatch, grads: torch.Tensor):
        """The in-place table update from planar per-key gradients
        [1+K, U]."""
        if self.pallas:
            return sweep_apply(state, pb.uids, grads, pb.ucounts, pb.valid,
                               self.param, block_rows=self.block_rows)
        return apply_pairs(state, pb.uids,
                           apply_payload(grads, pb.ucounts, pb.valid),
                           self.param)

    def train_step_prepped(self, state, pb: PreppedBatch):
        """pull -> forward -> backward -> per-key sums -> apply. The apply
        updates ``state`` in place (it replaces the TPU step's donated
        buffers). Returns (state, StepMetrics)."""
        pb = self._placed(pb, need_slots=self.sorted_grads)
        loc = Localized(uids=pb.uids, inv=pb.inv, counts=pb.ucounts,
                        valid=pb.valid)
        rows_u = self._pull(state, pb)
        if self.sorted_grads:
            ss = pb.sorted_slots
            grads, _, metrics = worker_grads_sorted(
                rows_u, loc, pb.vals, pb.labels, pb.mask,
                (ss.x_sorted, ss.bidx, ss.inv_sorted),
                slot_s=ss.slot_sorted, fields=self._fields(pb),
                **self.loss_kw,
            )
        else:
            grads_u, _, metrics = worker_grads(rows_u, loc, pb.vals,
                                               pb.labels, pb.mask,
                                               fields=self._fields(pb),
                                               **self.loss_kw)
            grads = grads_u.T
        return self._apply(state, pb, grads), metrics

    def eval_step_prepped(self, state,
                          pb: PreppedBatch) -> tuple[StepMetrics, torch.Tensor]:
        """pull -> forward. Returns (metrics, py [B])."""
        pb = self._placed(pb, need_slots=False)
        loc = Localized(uids=pb.uids, inv=pb.inv, counts=pb.ucounts,
                        valid=pb.valid)
        py, metrics = worker_forward(self._pull(state, pb), loc, pb.vals,
                                     pb.labels, pb.mask,
                                     fields=self._fields(pb), **self.loss_kw)
        return metrics, py

    def stats(self, state) -> dict[str, float]:
        return self.updater.stats(state)


def make_store(updater: FMUpdater, cfg: Config, device=None) -> LocalStore:
    """Store::Create. The port runs on one card: ``store=auto`` and
    ``store=local`` both give a LocalStore (``sharded`` is refused by the
    config, ROADMAP A9)."""
    return LocalStore(updater, cfg, device=device)
