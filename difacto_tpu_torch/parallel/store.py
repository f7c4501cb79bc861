"""Parameter store: one table on one device.

Port of ``difacto_tpu/parallel/store.py`` :: LocalStore (reference:
``src/store/store_local.h`` :: StoreLocal, which calls the updater in
process). A train step is

    pull -> [B, L] forward -> backward -> per-key sums -> apply, in place,

and an eval step is pull -> forward. The config picks the table path and
the per-key aggregation, as the JAX store does (``store.py:113-150,
243-249, 626-689``):

* ``kernel=pairs``: pull and apply of the batch's unique rows
  (ops/pair_sweep.py, B1, B2), over planar leaves (``layout=planar``) or
  over the row-major table (``layout=packed``, csrc/rowmajor_pairs.cu);
* ``kernel=pallas``: the whole-table sweep (ops/sweep.py, B4, B5), over
  either layout too (``layout=packed``: csrc/rowmajor_sweep.cu);
* ``kernel=xla``: gathers and masked scatter-adds of PyTorch tensor ops
  (updaters/updater.py, as the JAX package's are XLA ops), over the
  stacked table (``layout=stacked``, one gather serving the pull and the
  update), its hot/cold split (``hot_rows``), or planar or row-major
  leaves;
* ``kernel=auto``: ``xla`` with ``hot_rows`` or ``host_localize=0`` (as
  the JAX store resolves it) or ``layout=stacked``, else ``pairs``
  (measured on the H100; the JAX package's v5e rule "xla past 2^23
  rows" is not copied);
* ``segsum=sorted``: the sorted-slot backward and the segment-sum kernel
  (learners/step.py::worker_grads_sorted, B3); ``segsum=scatter``: the
  ``index_add_`` backward (worker_grads); ``segsum=auto``: sorted for
  pairs and xla, scatter for pallas. With ``cache_compact`` a batch's
  sorted slots keep only the sort permutation, and the step derives the
  rest on the device (learners/step.py::derive_sorted_slots).

A train step's phases are spans on the profiler's timeline
(utils/tracing.py): ``difacto.place``, ``difacto.pull``, the worker's
``difacto.loss`` and ``difacto.keysum`` (learners/step.py),
``difacto.apply``, and ``difacto.exchange`` around each collective of the
sharded store; each train step adds its slots, lanes and distinct rows
to the ``step`` counters.

The host-prepped steps (``train_step_prepped``, ``eval_step_prepped``)
take a batch localized by data/prep.py; ``train_step`` and ``eval_step``
take raw ids and localize them on the device (``host_localize=0``,
ops/localize.py), with the scatter backward, as the JAX store's do.
``kernel=pairs`` with ``host_localize=0`` is refused (the JAX store
trains it on its XLA ops; ROADMAP D). Every path runs the hand-written
kernels when the state lies on the card, their plain versions when it
lies on the CPU. ``loss=ffm`` runs every path with rows of 1 + F*k
floats (``Config.effective_model_param``) and the FFM math of
learners/step.py; with ``num_fields`` > 0 (libffm) every path reads the
batch's explicit fields, validated on the host. ``loss=autoint``
(models/autoint.py) runs the packed pairs path of this store alone
(``Config.check``): its state, an ``AutoIntState``, is the row-major table
and the dense weights with their Adam state; a train step updates the
dense part after the table's apply, on the device (``difacto.dense_apply``).

:class:`ShardedStore` (``store=sharded``) row-shards the table over the
ranks of a ``torch.distributed`` group, one shard a rank (parallel/comm.py),
as the JAX ShardedStore does over a device mesh: the owner of an id is
``id // rows_per_shard``, requests and gradients travel by all_to_all in
per-owner capacity buckets (overflow counted in ``dropped_ids``), and the
owner pulls and applies over the receive stream, S per-source segments:
the pair kernels B1 and K1 on ``kernel=pairs``, the updater's gather, a
dedup and B5 (or the updater) on ``kernel=pallas`` (``xla``). With no
group (S = 1) it is the pair path of :class:`LocalStore` on the same rows.
Under a multi-process launch (parallel/multihost.py) each rank is handed
its own process's rows and agrees the per-step capacity with the others
by a host allgather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data.prep import (PreppedBatch, ShardPreppedBatch, SortedSlots,
                         build_sorted_slots, build_sorted_slots_sharded,
                         validate_fields)
from ..learners.step import (StepMetrics, derive_sorted_slots,
                             worker_forward, worker_grads,
                             worker_grads_sorted)
from ..models.autoint import (AutoIntState, DenseState, Dims, adam_step,
                              f32_matmuls, init_dense)
from ..ops.localize import Localized, localize
from ..ops.pair_sweep import apply_pairs, pull_pairs
from ..ops.sweep import sweep_apply, sweep_pull
from ..ops.sweep_ms import apply_payload
from ..updaters.updater import (FMState, FMUpdater, HotColdFMState, LEAVES,
                                PackedFMState, StackedFMState, leaf_planes,
                                pack_state, stack_state, unpack_state)
from ..utils.device import resolve_device
from ..utils.place import place_batch
from ..utils.tracing import STEP, span, to_host
from .comm import Comm, allgather_host
from .multihost import process_count


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




def _count_step(slots: int, lanes: int, unique_rows: int | None) -> None:
    """A train step's work in the ``step`` counters (utils/tracing.py):
    its slots B*L, the unique lanes its kernels launch over, and the
    distinct rows among them when the host prep counted them."""
    STEP["steps"] += 1
    STEP["slots"] += slots
    STEP["lanes"] += lanes
    if unique_rows is not None:
        STEP["unique_rows"] += unique_rows


def _kernel_kind(cfg: Config) -> str:
    """pairs | pallas | xla. ``auto`` is ``xla`` with ``hot_rows`` (the
    split is a design of the XLA path) or ``host_localize=0`` (the pair
    kernels read host-prepped batches), as in the JAX store
    (``store.py:130-147``), and with ``layout=stacked``, the one path that
    takes that table (the JAX store's own CPU resolution); ``pairs``
    otherwise: the JAX store's "xla past 2^23 rows" is a v5e measurement,
    and on the H100 both paths are measured at 2^26 (PERF.md). ``pairs``
    with ``host_localize=0`` raises where the JAX store silently trains on
    its XLA ops (``Config.check``)."""
    kind = cfg.shard.kernel
    if kind == "auto":
        if (cfg.shard.hot_rows != 0 or not cfg.data.host_localize
                or cfg.shard.layout == "stacked"):
            return "xla"
        return "pairs"
    if kind not in ("xla", "pallas", "pairs"):
        raise ValueError(f"unknown kernel {kind!r}")
    return kind


def _resolve_layout(cfg: Config, kind: str) -> str:
    """planar = one array per leaf with V [K, N]; packed = one row-major
    [N, 4+2K] table, which the kernels of csrc/rowmajor_pairs.cu and
    csrc/rowmajor_sweep.cu read and write in a fifth of the 32-byte
    sectors; stacked = one [4+2K, N] table, the XLA path's (one gather
    and one scatter-add a step). The pairs and sweep paths take planar
    and packed; the JAX store refuses packed with its table kernels
    because XLA pads a 36-wide minor dimension to 128 lanes, a TPU
    mechanism that does not exist here. ``stacked`` needs ``kernel=xla``,
    as in the JAX store.

    ``auto`` on ``kernel=xla`` is stacked, as in the JAX store. On the
    kernel paths it follows what was measured on an H100 (PERF.md,
    section 6) and moves nobody onto a kernel that is slower. With
    factors (V_dim > 0) every row-major kernel, pairs and sweep, is faster
    than its planar counterpart for every updater pair, with the L2 warm
    and cold, at K = 16 and at FFM's K = F*k = 96 alike: packed. Without
    factors the row-major sweep kernels and the pair apply are faster
    too, but the pair pull reads w out of a table four times the size of
    the planar w and is slower with the L2 cold: packed on
    ``kernel=pallas``, planar on the pairs path."""
    lay = cfg.shard.layout
    if lay == "auto":
        if kind == "xla":
            return "stacked"
        packed = cfg.model.V_dim > 0 or kind == "pallas"
        return "packed" if packed else "planar"
    if lay not in ("packed", "planar", "stacked"):
        raise ValueError(f"layout must be auto|packed|planar|stacked, "
                         f"got {lay!r}")
    if lay == "stacked" and kind != "xla":
        raise ValueError(f"layout={lay} is incompatible with kernel="
                         f"{cfg.shard.kernel!r} (the table kernels read "
                         "planar or row-major tables)")
    return lay


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class LocalStore:
    """Single-device store (reference: StoreLocal + local Tracker).

    ``device`` defaults to the card; without one it raises unless the
    caller asks for ``"cpu"`` (utils/device.py). The state's tensors are
    updated IN PLACE by every train step: the step returns the same
    state object it was given (an FMState, a PackedFMState with
    ``layout=packed``, a StackedFMState with ``layout=stacked``, a
    HotColdFMState with ``hot_rows``)."""

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
        # loss=autoint: the widths of its dense part (None for FM and FFM)
        self.attn = Dims.of(cfg) if self.loss == "autoint" else None
        if self.attn is not None:
            f32_matmuls()
        s = cfg.shard
        self.kernel = _kernel_kind(cfg)
        self.pallas = self.kernel == "pallas"
        self.xla = self.kernel == "xla"
        self.layout = _resolve_layout(cfg, self.kernel)
        self.block_rows = min(s.block_rows, self.num_rows)
        # the unique-lane count of a device-localized batch
        self.unique_size = s.unique_size or (
            cfg.data.batch_size * cfg.data.max_nnz_per_row)
        # segsum=auto: the sorted backward on pairs and xla, scatter on
        # pallas (the JAX store's choice on its accelerator)
        self.sorted_grads = s.segsum == "sorted" or (
            s.segsum == "auto" and not self.pallas)
        # hot/cold split (HotColdFMState + data/remap.py); -1 auto-sizes
        self.hot_rows = s.hot_rows
        if self.hot_rows:
            if not self.xla:
                raise ValueError("hot_rows needs kernel=xla (the table "
                                 "kernels address a single table)")
            if self.layout != "stacked":
                raise ValueError("hot_rows needs layout=stacked (or auto)")
            if self.hot_rows == -1:
                from ..data.remap import auto_hot_rows

                self.hot_rows = auto_hot_rows(self.num_rows, self.param.V_dim)
            if not 0 < self.hot_rows < self.num_rows:
                raise ValueError(f"hot_rows {self.hot_rows} out of range for "
                                 f"a {self.num_rows}-row table")
        self.hot_lut = None  # set by set_remap before any state is placed

    def init_state(self, seed: int = 0):
        u, n, dev = self.updater, self.num_rows, self.device
        if self.attn is not None:
            return AutoIntState(tbl=u.init_state_packed(n, seed, dev).tbl,
                                dense=init_dense(self.attn, seed, dev))
        if self.hot_rows:
            return u.init_state_hotcold(n, self.hot_rows, seed, dev)
        init = {"packed": u.init_state_packed,
                "stacked": u.init_state_stacked}.get(self.layout, u.init_state)
        return init(n, seed, dev)

    def set_remap(self, lut: np.ndarray) -> None:
        """Install the frequency remap (data/remap.py::build_remap). Prep
        must apply the same lut to every batch (the learner threads it
        into prep_batch); the store needs it to place canonical state and
        the checkpoint to save it."""
        if not self.hot_rows:
            raise ValueError("set_remap on a store without hot_rows")
        if lut.shape != (self.num_rows,):
            raise ValueError(f"remap lut of shape {lut.shape}, expected "
                             f"({self.num_rows},)")
        self.hot_lut = lut

    def place_state(self, host_state, dense: dict | None = None):
        """Move a state of any layout with the six leaves (a checkpoint's
        FMState, a PackedFMState or a StackedFMState, anywhere) onto this
        store's device, in this store's layout; ``loss=autoint`` takes its
        dense part from ``dense`` (utils/checkpoint.py's ``read_dense``:
        ``theta``, ``m``, ``v``, ``step``). A single-file checkpoint
        from a padded sharded run carries more rows than the hash space;
        the extra rows must be zero and are cut off. The stacked and
        hot/cold tables are written one [N] plane at a time (no planar
        copy beside the table on the device); a hot/cold store permutes
        each canonical plane into remapped rows by its lut."""
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
        if self.layout == "stacked":
            return self._place_planes(host_state)
        N = self.num_rows
        packed_in = isinstance(host_state, PackedFMState)
        if packed_in:
            placed = PackedFMState(tbl=host_state.tbl[:N].to(
                self.device, torch.float32).contiguous())
        else:
            placed = FMState(**{
                name: getattr(host_state, name)[..., :N].to(
                    self.device, torch.float32).contiguous()
                for name in LEAVES})
        if packed_in != (self.layout == "packed"):
            placed = pack_state(placed) if self.layout == "packed" else (
                unpack_state(placed))
        if self.attn is None:
            return placed
        if dense is None:
            raise ValueError("loss=autoint: the checkpoint holds no dense "
                             "weights (not an AutoInt model)")
        return AutoIntState(tbl=placed.tbl, dense=DenseState.of(
            self.attn, self.device, dense["theta"], dense["m"], dense["v"],
            dense["step"]))

    def _place_planes(self, host_state):
        """place_state for the stacked and hot/cold tables, plane by
        plane (JAX ``store.py:313-373``), through the leaf views of
        :class:`StackedFMState`."""
        N, k, dev = self.num_rows, self.param.V_dim, self.device
        H = self.hot_rows
        if H and self.hot_lut is None:
            raise ValueError(
                "a hot_rows store cannot place a checkpoint before "
                "set_remap() — the learner installs the frequency remap "
                "first")
        tables = [StackedFMState(tbl=torch.zeros(
            (4 + 2 * k, n), dtype=torch.float32, device=dev))
            for n in ((H, N - H) if H else (N,))]
        if H:
            lut = torch.as_tensor(self.hot_lut, device=dev).long()
            buf = torch.empty(N, dtype=torch.float32, device=dev)
        for name in LEAVES:
            src = leaf_planes(getattr(host_state, name))
            dst = [leaf_planes(getattr(t, name)) for t in tables]
            for j in range(src.shape[0]):
                plane = src[j, :N].to(dev, torch.float32)
                if H:
                    buf.index_copy_(0, lut, plane)  # canonical -> remapped
                    dst[0][j].copy_(buf[:H])
                    dst[1][j].copy_(buf[H:])
                else:
                    dst[0][j].copy_(plane)
        if H:
            return HotColdFMState(hot=tables[0].tbl, cold=tables[1].tbl)
        return tables[0]

    def shard_batch(self, ids, vals, labels, mask, fields=None):
        """A raw batch's arrays for a step, with its fields validated
        when the config declares them (JAX ``store.py:379-382``)."""
        if self.expects_fields:
            return ids, vals, labels, mask, _require_fields(
                fields, self.num_fields)
        return ids, vals, labels, mask

    def count_step(self, state, ids):
        """Feature-frequency pass, in place (reference: Store::kFeaCount
        push used for tail filtering before training). A hot/cold state
        takes remapped ids (the learner relabels them as prep does)."""
        return self.updater.add_counts(state, _as_tensor(ids, self.device))

    def _placed(self, pb: PreppedBatch, need_slots: bool) -> PreppedBatch:
        """The batch as tensors on this store's device. Host batches get
        their sorted slots built here when the prep workers did not
        (kept on the batch, so replayed batches reuse them), in the
        compact form when the config asks (``cache_compact``, JAX
        ``store.py:609-624``); FFM's and AutoInt's also keep the sort
        permutation. Explicit fields are checked first (on the host array,
        when the batch is still there) unless the prep did."""
        with span("difacto.place"):
            if self.hot_rows and pb.uids_hot is None:
                raise ValueError(
                    "hot_rows store got an unsplit PreppedBatch — prep "
                    "must run with (remap, hot_rows) (the learner threads "
                    "them)")
            if self.expects_fields:
                pb.fields = _prepped_fields(pb, self.num_fields)
                pb.fields_checked = True
            slots = self.cfg.slot_grads()
            ss = pb.sorted_slots
            if need_slots and (ss is None
                               or (slots and ss.slot_sorted is None)):
                if isinstance(pb.inv, torch.Tensor):
                    raise ValueError(
                        "a placed batch needs its sorted slots built "
                        "before placement (data/prep.py)")
                pb.sorted_slots = build_sorted_slots(
                    pb.inv, pb.vals, with_slots=slots,
                    compact=self.cfg.data.cache_compact)
            return place_batch(pb, self.device)

    def _fields(self, fields):
        """The batch's fields for the loss: None unless the config
        declares them (then FFM's field is the slot position)."""
        return fields if self.expects_fields else None

    def _pull(self, state, loc: Localized, split=None):
        """Unique rows [U, 1+K] (w | count-gated V) of the batch, lanes
        past its real unique count zero (the valid mask), and on the XLA
        path's stacked tables the raw [D, U] gather the update reuses
        (else None). ``split``: the hot and cold buckets of a split
        batch."""
        with span("difacto.pull"):
            valid = loc.valid
            if self.pallas:
                return sweep_pull(state, loc.uids, valid, self.param,
                                  block_rows=self.block_rows), None
            if self.xla:
                if split is not None:
                    raw = self.updater.pull_raw_split(state, *split)
                elif isinstance(state, StackedFMState):
                    raw = self.updater.pull_raw(state, loc.uids, valid)
                else:
                    return self.updater.pull(state, loc.uids, valid), None
                return self.updater.rows_view(raw, valid), raw
            rows_p = pull_pairs(state, loc.uids, self.param)
            return torch.where(valid[:, None], rows_p.T, 0.0), None

    def _apply(self, state, loc: Localized, grads: torch.Tensor, raw,
               split=None):
        """The in-place table update from planar per-key gradients
        [1+K, U]."""
        with span("difacto.apply"):
            if self.pallas:
                return sweep_apply(state, loc.uids, grads, loc.counts,
                                   loc.valid, self.param,
                                   block_rows=self.block_rows)
            if self.xla:
                # zero the lanes no slot visits, as the JAX store does
                # before its update: its masks multiply, and 0 x Inf
                # commits a NaN
                grads_u = torch.where(loc.valid[:, None], grads.T, 0.0)
                if split is not None:
                    return self.updater.update_split(
                        state, *split, grads_u, loc.counts, loc.valid, raw)
                return self.updater.update(state, loc.uids, grads_u,
                                           loc.counts, loc.valid, rows=raw)
            return apply_pairs(state, loc.uids,
                               apply_payload(grads, loc.counts, loc.valid),
                               self.param)

    def _split(self, pb: PreppedBatch):
        return (pb.uids_hot, pb.uids_cold) if self.hot_rows else None

    def _dense(self, state):
        """The dense part of ``loss=autoint``'s state, else None."""
        return state.dense if self.attn is not None else None

    def train_step_prepped(self, state, pb: PreppedBatch):
        """pull -> forward -> backward -> per-key sums -> apply (-> the
        dense part's Adam, ``loss=autoint``). The apply updates ``state``
        in place (it replaces the TPU step's donated buffers); on the XLA
        path one gather serves the pull and the update. Returns (state,
        StepMetrics)."""
        pb = self._placed(pb, need_slots=self.sorted_grads)
        loc = Localized(uids=pb.uids, inv=pb.inv, counts=pb.ucounts,
                        valid=pb.valid)
        _count_step(pb.inv.shape[0], pb.uids.shape[0], pb.n_real)
        split = self._split(pb)
        rows_u, raw = self._pull(state, loc, split)
        fields = self._fields(pb.fields)
        if self.sorted_grads:
            ss = pb.sorted_slots
            stream = (derive_sorted_slots(pb.vals, pb.inv, ss.slot_sorted)
                      if ss.compact else (ss.x_sorted, ss.bidx, ss.inv_sorted))
            grads, _, metrics = worker_grads_sorted(
                rows_u, loc, pb.vals, pb.labels, pb.mask, stream,
                slot_s=ss.slot_sorted, fields=fields,
                dense=self._dense(state), **self.loss_kw,
            )
        else:
            grads_u, _, metrics = worker_grads(rows_u, loc, pb.vals,
                                               pb.labels, pb.mask,
                                               fields=fields,
                                               dense=self._dense(state),
                                               **self.loss_kw)
            grads = grads_u.T
        out = self._apply(state, loc, grads, raw, split)
        if self.attn is not None:
            adam_step(state.dense, self.cfg.autoint)
        return out, metrics

    def eval_step_prepped(self, state,
                          pb: PreppedBatch) -> tuple[StepMetrics, torch.Tensor]:
        """pull -> forward. Returns (metrics, py [B])."""
        pb = self._placed(pb, need_slots=False)
        loc = Localized(uids=pb.uids, inv=pb.inv, counts=pb.ucounts,
                        valid=pb.valid)
        rows_u, _ = self._pull(state, loc, self._split(pb))
        py, metrics = worker_forward(rows_u, loc, pb.vals, pb.labels,
                                     pb.mask, fields=self._fields(pb.fields),
                                     dense=self._dense(state), **self.loss_kw)
        return metrics, py

    # -- device-localized path (host_localize=0): raw ids, localized on the
    # device (ops/localize.py), the scatter backward (JAX store.py:403-458)

    def _raw(self, ids, vals, labels, mask, fields):
        if self.kernel == "pairs":
            raise ValueError("kernel=pairs needs host-prepped batches (the "
                             "JAX store would train this step on its XLA "
                             "ops)")
        if self.hot_rows:
            raise ValueError(
                "hot_rows needs host-prepped batches (host_localize=1): "
                "the hot/cold bucket split and the frequency remap are "
                "host-side prep work")
        if self.expects_fields:
            if fields is None:
                raise ValueError("num_fields > 0 but this batch carries no "
                                 "field ids (use data_format=libffm)")
            if not isinstance(fields, torch.Tensor):
                validate_fields(np.asarray(fields), self.num_fields)
            fields = _as_tensor(fields, self.device)
        else:
            fields = None
        ids = _as_tensor(ids, self.device, torch.int32)
        loc = localize(ids, self.num_rows, self.unique_size)
        return (loc, _as_tensor(vals, self.device, torch.float32),
                _as_tensor(labels, self.device, torch.float32),
                _as_tensor(mask, self.device, torch.float32), fields)

    def train_step(self, state, ids, vals, labels, mask, fields=None):
        """A train step on a raw batch (``ids`` i32 [B, L], PAD_ID -1),
        localized on the device into ``unique_size`` lanes; distinct ids
        past them are dropped and counted in ``dropped_ids``. Host
        arrays or tensors on any device. Returns (state, StepMetrics)."""
        loc, vals, labels, mask, fields = self._raw(ids, vals, labels, mask,
                                                    fields)
        _count_step(loc.inv.shape[0], loc.uids.shape[0], None)
        rows_u, raw = self._pull(state, loc)
        grads_u, _, metrics = worker_grads(rows_u, loc, vals, labels, mask,
                                           fields=fields, **self.loss_kw)
        state = self._apply(state, loc, grads_u.T, raw)
        return state, metrics._replace(
            dropped_ids=metrics.dropped_ids + loc.overflow)

    def eval_step(self, state, ids, vals, labels, mask,
                  fields=None) -> tuple[StepMetrics, torch.Tensor]:
        """An eval step on a raw batch. Returns (metrics, py [B])."""
        loc, vals, labels, mask, fields = self._raw(ids, vals, labels, mask,
                                                    fields)
        rows_u, _ = self._pull(state, loc)
        py, metrics = worker_forward(rows_u, loc, vals, labels, mask,
                                     fields=fields, **self.loss_kw)
        return metrics._replace(
            dropped_ids=metrics.dropped_ids + loc.overflow), py

    def stats(self, state) -> dict[str, float]:
        return self.updater.stats(state)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _cap_ladder(c: int) -> int:
    """A capacity rounded up a ~1.5x geometric ladder of 128-multiples, so
    that batches land on few distinct capacities (the JAX package's
    ladder: each capacity was a compile there; it is kept so that the
    capacities, and with them ``dropped_ids``, match)."""
    v = 128
    while v < c:
        v = _round_up(int(v * 3 / 2), 128)
    return v


# the lane window of the JAX pair kernels: their capacity is a multiple of
# it, and so is this store's on kernel=pairs, so that both drop the same
# ids (the Hopper kernels take any capacity)
PAIR_WINDOW = 128


class ShardedStore(LocalStore):
    """Row-sharded store over a ``torch.distributed`` group (reference:
    StoreDist over ps-lite; port of the JAX ShardedStore,
    ``difacto_tpu/parallel/store.py:818-1732``). Rank r holds rows
    ``[r * rows_per_shard, (r+1) * rows_per_shard)`` of a table padded up
    so that S ranks divide it in whole ``block_rows`` (padded rows are
    never hashed into and hold zeros), in the layout ``LocalStore``
    resolves. The train and eval steps return the metrics summed over the
    ranks (``psum``). A rank's batches come in one of two forms:

    * the GLOBAL batch, the same on every rank, prepped over S row groups
      (data/prep.py::prep_batch_sharded); each rank steps its own group,
      reads the capacity from the batch with no collective, and an eval
      step returns the scores of the whole batch. ``run_ranks`` groups
      (parallel/launch.py) and one process (S = 1) run so;
    * this process's own rows alone (``local_rows``: a multi-process
      launch, JAX's ``process_count() > 1``), prepped as one
      row group for S owners at the fixed bucket ``unique_size``; the
      pairs capacity is agreed per step by one host allgather of the
      ranks' largest bucket fills (JAX ``_mp_pairs_capacity``), and an
      eval step returns this rank's scores.

    S is the size of the initialized default group, 1 without one
    (parallel/comm.py). ``device``
    defaults to the card and raises without one unless the caller passes
    ``"cpu"``. The train step updates the rank's shard in place."""

    def __init__(self, updater: FMUpdater, cfg: Config, device=None):
        if cfg.shard.hot_rows:
            raise ValueError(
                "hot_rows is a LocalStore big-table feature (store=local): "
                "a sharded table's shards are small already")
        if cfg.learner.loss == "autoint":
            raise ValueError("loss=autoint runs on store=local: the dense "
                             "weights and their Adam state live on one card")
        super().__init__(updater, cfg, device=device)
        self.comm = Comm()
        S = self.S = self.comm.size
        self.rank = self.comm.rank
        self.local_rows = process_count() > 1
        if cfg.shard.num_shards and cfg.shard.num_shards != S:
            raise ValueError(f"num_shards {cfg.shard.num_shards} is not the "
                             f"process group's size {S} (one shard a rank)")
        if cfg.data.batch_size % S:
            raise ValueError(f"{S} ranks must divide batch_size "
                             f"{cfg.data.batch_size}")
        # hashed ids live in [0, 2^num_bits); the table pads up so that S
        # divides it in block-aligned shards (a non-power-of-two S, as the
        # reference's key ranges allowed any server count)
        self.hash_rows = 1 << cfg.data.num_bits
        per = -(-self.hash_rows // S)
        self.rows_per_shard = _round_up(per, min(cfg.shard.block_rows, per))
        self.num_rows = self.rows_per_shard * S
        self.block_rows = min(cfg.shard.block_rows, self.rows_per_shard)
        self.lo = self.rank * self.rows_per_shard
        self.unique_size = cfg.shard.unique_size or (
            cfg.data.batch_size // S * cfg.data.max_nnz_per_row)
        self.pairs = self.kernel == "pairs"
        # the all_to_all capacity for the worst case (device-localized
        # batches, and the floor an explicit unique_size sets)
        self.capacity = self._capacity_for(self.unique_size)
        # the epoch pin of the pairs capacity (pin_capacity)
        self._cap_seen = 0
        self._cap_pin: int | None = None

    # -- all_to_all capacity (JAX store.py:1007-1063, kept verbatim so that
    # the same batches drop the same ids) ----------------------------------

    def _capacity_for(self, unique_lanes: int) -> int:
        """The per-(source, owner) slot capacity for a rank's unique-lane
        count: its even share times ``capacity_factor``, 8-aligned; a
        multiple of the pair window on ``kernel=pairs``."""
        perfect = -(-unique_lanes // self.S)
        c = _round_up(max(int(perfect * self.cfg.shard.capacity_factor), 8),
                      8)
        return _round_up(c, PAIR_WINDOW) if self.pairs else c

    def pairs_capacity(self, pb: ShardPreppedBatch) -> int:
        """The capacity of the pairs path for one batch: its largest
        (source, owner) bucket fill (``pb.max_fill``, which prep takes on
        the host by data/prep.py::shard_bucket_fills over this store's
        rows), W-aligned (no drops), then :meth:`_cap_resolve`. Every rank
        reads it from the global batch; of ``local_rows`` batches, each
        rank knows only its own fills, and the largest is agreed by one
        host allgather (JAX ``_mp_pairs_capacity``), so that every rank
        resolves the same capacity and pin. A collective: every rank calls
        it at the same step, on its main thread."""
        need = pb.max_fill
        if self.local_rows and self.S > 1:
            need = int(allgather_host(np.array(need, np.int64)).max())
        return self._cap_resolve(_round_up(max(need, 1), PAIR_WINDOW))

    def _cap_resolve(self, c: int) -> int:
        """Exact W-aligned need -> served capacity: the epoch pin when it
        fits, else the ``unique_size`` floor and the ladder."""
        self._cap_seen = max(self._cap_seen, c)
        if self._cap_pin is not None and c <= self._cap_pin:
            return self._cap_pin
        if self.cfg.shard.unique_size:
            c = max(c, self.capacity)
        return _cap_ladder(c)

    def pin_capacity(self) -> int:
        """Pin the pairs capacity to the largest exact need seen so far
        (the learner calls it at each epoch boundary). Returns the pin."""
        if self._cap_seen:
            self._cap_pin = max(self._cap_pin or 0, self._cap_seen)
        return self._cap_pin or 0

    # -- state --------------------------------------------------------------

    def _shard_of(self, leaves, rows_in: int):
        """This rank's rows of the planar leaves ``leaves`` (name ->
        [.., rows_in] tensor, anywhere), zero-padded past ``rows_in``, on
        the device in this store's layout."""
        lo, hi = self.lo, self.lo + self.rows_per_shard
        return self.place_rows({name: leaves[name][..., lo:min(hi, rows_in)]
                                for name in LEAVES})

    def place_rows(self, leaves):
        """This rank's rows ``[lo, lo + rows_per_shard)`` from planar
        leaves that hold them from ``lo`` on (name -> [.., r] tensor or
        NumPy array, r <= rows_per_shard; zero-padded past r), on the
        device in this store's layout (a per-process checkpoint's
        pieces)."""
        out = {}
        for name in LEAVES:
            x = torch.as_tensor(leaves[name]).to(self.device, torch.float32)
            pad = self.rows_per_shard - x.shape[-1]
            out[name] = (torch.nn.functional.pad(x, (0, pad)) if pad
                         else x).contiguous()
        st = FMState(**out)
        if self.layout == "packed":
            return pack_state(st)
        if self.layout == "stacked":
            return stack_state(st)
        return st

    def init_state(self, seed: int = 0):
        """Initialized over the HASH space, as one table, then this rank's
        rows (zero padding past the hash space): the model depends on
        ``num_bits`` and ``seed`` alone, not on S (JAX
        ``store.py:1093-1121``)."""
        full = self.updater.init_state(self.hash_rows, seed, self.device)
        return self._shard_of({n: getattr(full, n) for n in LEAVES},
                              self.hash_rows)

    def place_state(self, host_state):
        """This rank's rows of a whole table in any layout with the six
        leaves (a checkpoint's FMState), on the device in this store's
        layout. The table may lack the padding rows (they are zeros) but
        not rows of the hash space (JAX ``store.py:1693-1729``)."""
        n_in = host_state.num_rows
        if n_in < self.hash_rows or n_in > self.num_rows:
            raise ValueError(
                f"checkpoint has {n_in} rows; this store's hash space is "
                f"{self.hash_rows} (padded table {self.num_rows}) — "
                "num_bits mismatch?")
        if host_state.k != self.param.V_dim:
            raise ValueError(f"checkpoint has V_dim {host_state.k} but this "
                             f"store expects {self.param.V_dim} (F*k for "
                             "loss=ffm)")
        return self._shard_of({n: getattr(host_state, n) for n in LEAVES},
                              n_in)

    def gather_state(self, state) -> FMState:
        """The whole padded table as a planar FMState on the CPU, every
        rank's rows in order (the checkpoint's and the tests' view; JAX's
        ``device_get`` of the global state). A collective: every rank
        calls it."""
        out = {}
        for name in LEAVES:
            planes = leaf_planes(getattr(state, name))
            full = torch.zeros((planes.shape[0], self.num_rows))
            for j in range(planes.shape[0]):
                full[j] = self.comm.all_gather(
                    planes[j].contiguous()).reshape(-1).cpu()
            out[name] = full if name in ("V", "nV") else full[0]
        return FMState(**out)

    def stats(self, state) -> dict[str, float]:
        local = self.updater.stats(state)
        keys = sorted(local)
        tot = self.comm.all_reduce(torch.tensor(
            [local[k] for k in keys], dtype=torch.float64, device=self.device))
        return {k: float(v) for k, v in zip(keys, to_host(tot).tolist())}

    # -- this rank's part of a global batch ----------------------------------

    def _rows(self, x):
        """This rank's row group of a global [B, ...] array (a
        ``local_rows`` batch is this rank's already)."""
        if x is None or self.local_rows:
            return x
        bs = x.shape[0] // self.S
        return x[self.rank * bs:(self.rank + 1) * bs]

    def _local(self, pb: ShardPreppedBatch, need_slots: bool):
        """(this rank's PreppedBatch on the device, its prep drops)."""
        if not isinstance(pb, ShardPreppedBatch):
            raise TypeError("the sharded store takes a ShardPreppedBatch "
                            "(data/prep.py::prep_batch_sharded)")
        groups = 1 if self.local_rows else self.S
        if pb.num_shards != groups:
            raise ValueError(f"batch prepped over {pb.num_shards} groups for "
                             f"{self.S} ranks (local rows: "
                             f"{self.local_rows})")
        if self.expects_fields:
            pb.fields = _prepped_fields(pb, self.num_fields)
            pb.fields_checked = True
        ffm = self.loss == "ffm"
        ss = pb.sorted_slots
        if ss is not None and ss.compact:
            raise ValueError(
                "the sharded store takes the full sorted slots: "
                "cache_compact is a LocalStore form, and the sharded prep "
                "(build_sorted_slots_sharded) never builds it")
        if need_slots and (ss is None or (ffm and ss.slot_sorted is None)):
            if isinstance(pb.inv, torch.Tensor):
                raise ValueError("a placed batch needs its sorted slots "
                                 "built before placement (data/prep.py)")
            pb.sorted_slots = ss = build_sorted_slots_sharded(
                pb, with_slots=ffm)
        r, ub = 0 if self.local_rows else self.rank, pb.ub
        lanes = slice(r * ub, (r + 1) * ub)
        nl = pb.inv.shape[0] // groups
        local = PreppedBatch(
            vals=self._rows(pb.vals), labels=self._rows(pb.labels),
            mask=self._rows(pb.mask), uids=pb.uids[lanes],
            ucounts=pb.ucounts[lanes], inv=pb.inv[r * nl:(r + 1) * nl],
            valid=pb.valid[lanes], fields=self._rows(pb.fields),
            fields_checked=pb.fields_checked,
            n_real=None if pb.n_real is None else pb.n_real[r],
            sorted_slots=None if ss is None or not need_slots else
            SortedSlots(x_sorted=ss.x_sorted[r], bidx=ss.bidx[r],
                        inv_sorted=ss.inv_sorted[r],
                        slot_sorted=None if ss.slot_sorted is None
                        else ss.slot_sorted[r]))
        return place_batch(local, self.device), pb.dropped[r]

    # -- the per-rank program (JAX: inside shard_map) ------------------------

    def _routing(self, loc: Localized, C: int):
        """Scatter-form routing: each sorted unique lane's slot in the
        per-owner send buckets, ``pos`` (S*C for a lane not sent), and the
        lanes a full bucket drops (JAX ``store.py:1304``)."""
        S, U = self.S, loc.uids.shape[0]
        owner = torch.clamp(loc.uids.long() // self.rows_per_shard,
                            max=S - 1)
        start = torch.searchsorted(
            owner, torch.arange(S, device=owner.device, dtype=owner.dtype))
        slot = torch.arange(U, device=owner.device) - start[owner]
        ok = loc.valid & (slot < C)
        pos = torch.where(ok, owner * C + slot, S * C)
        return pos, ok, (loc.valid & ~ok).to(torch.float32).sum()

    def _gather_routing(self, loc: Localized, C: int):
        """Gather-form routing of the pairs path (JAX ``store.py:1472``):
        send slot (o, j) reads unique lane ``start[o] + j`` (``src``, sent
        where ``take``); lane -> its slot ``pos``, ``ok`` where it was
        sent; the lanes a full bucket drops."""
        S, U = self.S, loc.uids.shape[0]
        dev = loc.uids.device
        bnds = torch.arange(S + 1, device=dev, dtype=torch.int64) * (
            self.rows_per_shard)
        # st[S] is the first sentinel lane (sentinel = num_rows = S * rps)
        st = torch.searchsorted(loc.uids.long(), bnds)
        cnt = st[1:] - st[:-1]
        t = torch.arange(S * C, device=dev)
        o = t // C
        j = t - o * C
        src = st[:-1][o] + j
        take = j < cnt[o]
        owner = torch.clamp(loc.uids.long() // self.rows_per_shard,
                            max=S - 1)
        slot = torch.arange(U, device=dev) - st[:-1][owner]
        ok = loc.valid & (slot < C)
        pos = torch.where(ok, owner * C + slot, S * C - 1)
        return src, take, pos, ok, (loc.valid & ~ok).to(torch.float32).sum()

    def _receive(self, recv_ids: torch.Tensor):
        """The owner's view of the received ids: local rows, the local
        sentinel ``rows_per_shard`` on empty slots, and the valid mask."""
        rvalid = recv_ids >= 0
        rl = torch.where(rvalid, recv_ids - self.lo,
                         self.rows_per_shard).to(torch.int32)
        return rl, rvalid

    def _routed_pull(self, state, loc: Localized, C: int):
        """The XLA and sweep paths' pull (JAX ``store.py:1319``): ids to
        their owners, the owner's gather, rows back. Returns (rows_u
        [U, 1+K], the push's context, lanes dropped)."""
        S = self.S
        pos, ok, dropped = self._routing(loc, C)
        send_ids = torch.full((S * C + 1,), -1, dtype=torch.int32,
                              device=loc.uids.device)
        send_ids[pos] = torch.where(ok, loc.uids, -1).to(torch.int32)
        rl, rvalid = self._receive(self.comm.all_to_all(send_ids[:S * C]))
        rows_local = self.updater.pull(state, rl, rvalid)  # [S*C, 1+K]
        rows_back = self.comm.all_to_all(rows_local)
        rows_u = torch.where(ok[:, None],
                             rows_back[pos.clamp(max=S * C - 1)], 0.0)
        return rows_u, (pos, ok, rl, rvalid), dropped

    def _routed_push(self, state, loc: Localized, grads: torch.Tensor, ctx,
                     C: int):
        """Per-key gradients (planar [1+K, U]) and counts to their owners;
        the owner dedups its S*C received lanes (``torch.unique``, padded
        to S*C with the local sentinel), sums them (``index_add_``) and
        applies once a row: B5 on ``kernel=pallas``, the updater on
        ``kernel=xla`` (JAX ``store.py:1343-1386``)."""
        S, D = self.S, grads.shape[0]
        pos, ok, rl, rvalid = ctx
        payload = torch.cat([grads.T, loc.counts[:, None]], dim=1)
        send = torch.zeros((S * C + 1, D + 1), dtype=torch.float32,
                           device=payload.device)
        send[pos] = torch.where(ok[:, None], payload, 0.0)
        recv = self.comm.all_to_all(send[:S * C])
        rps = self.rows_per_shard
        ouids, oinv = torch.unique(rl, sorted=True, return_inverse=True)
        ouids = torch.nn.functional.pad(ouids, (0, S * C - ouids.shape[0]),
                                        value=rps).to(torch.int32)
        ovalid = ouids < rps
        agg = torch.zeros((S * C, D + 1), dtype=torch.float32,
                          device=recv.device)
        agg.index_add_(0, oinv, recv * rvalid[:, None].to(torch.float32))
        if self.pallas:
            return sweep_apply(state, ouids, agg[:, :D].T, agg[:, D], ovalid,
                               self.param, block_rows=self.block_rows)
        return self.updater.update(state, ouids, agg[:, :D], agg[:, D],
                                   ovalid)

    def _pull_pairs(self, state, loc: Localized, C: int):
        """The pairs path's pull (JAX ``store.py:1504``): B1 over the
        owner's receive stream, S sorted segments of C lanes. S = 1 is
        LocalStore's pull on the rank's own stream."""
        if self.S == 1:
            rows_u, _ = self._pull(state, loc)
            return rows_u, None, torch.zeros((), device=loc.uids.device)
        S, U = self.S, loc.uids.shape[0]
        src, take, pos, ok, dropped = self._gather_routing(loc, C)
        send_ids = torch.where(take, loc.uids[src.clamp(max=U - 1)], -1)
        rl, rvalid = self._receive(self.comm.all_to_all(
            send_ids.to(torch.int32)))
        rows_p = pull_pairs(state, rl, self.param)  # [1+K, S*C]
        rows_back = self.comm.all_to_all(
            torch.where(rvalid[:, None], rows_p.T, 0.0))
        rows_u = torch.where(ok[:, None], rows_back[pos], 0.0)
        return rows_u, (src, take, rl, rvalid), dropped

    def _push_pairs(self, state, loc: Localized, grads: torch.Tensor, ctx,
                    C: int):
        """The pairs path's push (JAX ``store.py:1554``): gradients to
        their owners, then K1, B2 over the S segments of the receive
        stream, each row once with its total. S = 1 is LocalStore's
        apply."""
        if self.S == 1:
            return self._apply(state, loc, grads, None)
        U, D = loc.uids.shape[0], grads.shape[0]
        src, take, rl, rvalid = ctx
        payload = torch.cat([grads.T, loc.counts[:, None]], dim=1)
        send = torch.where(take[:, None], payload[src.clamp(max=U - 1)], 0.0)
        recv = self.comm.all_to_all(send)
        rf = rvalid.to(torch.float32)
        # planar gw | gV | add_cnt | touch; an id several sources sent
        # spans several segments, and K1 sums them before its one update
        pay = torch.cat([recv[:, :D].T * rf[None, :],
                         (recv[:, D] * rf)[None, :], rf[None, :]], dim=0)
        return apply_pairs(state, rl, pay, self.param, seg_len=C)

    def _sum_metrics(self, metrics: StepMetrics, dropped) -> StepMetrics:
        """The step's metrics summed over the ranks (``psum``), in one
        all_reduce."""
        m = metrics._replace(dropped_ids=metrics.dropped_ids + dropped)
        if self.S == 1:
            return m
        flat = self.comm.all_reduce(torch.cat([t.reshape(-1) for t in m]))
        out, at = [], 0
        for t in m:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return StepMetrics(*out)

    # -- steps ---------------------------------------------------------------

    def _route(self, pb: ShardPreppedBatch, loc: Localized):
        """(pull, push, capacity) of the table path for this batch."""
        if self.pairs:
            return self._pull_pairs, self._push_pairs, self.pairs_capacity(pb)
        return (self._routed_pull, self._routed_push,
                self._capacity_for(loc.uids.shape[0]))

    def train_step_prepped(self, state, pb: ShardPreppedBatch):
        """This rank's row group of ``pb``: pull -> forward -> backward
        (scatter, or B3 on the rank's sorted slots, before routing) ->
        push and apply on the owners. Returns (state, metrics summed over
        the ranks)."""
        with span("difacto.place"):
            lb, dropped_prep = self._local(pb, need_slots=self.sorted_grads)
        loc = Localized(uids=lb.uids, inv=lb.inv, counts=lb.ucounts,
                        valid=lb.valid)
        _count_step(lb.inv.shape[0], lb.uids.shape[0], lb.n_real)
        pull, push, C = self._route(pb, loc)
        with span("difacto.pull"):
            rows_u, ctx, dropped = pull(state, loc, C)
        fields = self._fields(lb.fields)
        if self.sorted_grads:
            ss = lb.sorted_slots
            grads, _, metrics = worker_grads_sorted(
                rows_u, loc, lb.vals, lb.labels, lb.mask,
                (ss.x_sorted, ss.bidx, ss.inv_sorted),
                slot_s=ss.slot_sorted, fields=fields, **self.loss_kw)
        else:
            grads_u, _, metrics = worker_grads(rows_u, loc, lb.vals,
                                               lb.labels, lb.mask,
                                               fields=fields, **self.loss_kw)
            grads = grads_u.T
        with span("difacto.apply"):
            state = push(state, loc, grads, ctx, C)
        return state, self._sum_metrics(metrics, dropped + dropped_prep)

    def _gather_py(self, py: torch.Tensor) -> torch.Tensor:
        """The whole batch's scores, or this rank's of a ``local_rows``
        batch (JAX ``SGDLearner._local_scores``)."""
        if self.local_rows:
            return py
        return self.comm.all_gather(py).reshape(-1)

    def eval_step_prepped(self, state, pb: ShardPreppedBatch
                          ) -> tuple[StepMetrics, torch.Tensor]:
        """pull -> forward. Returns (metrics summed over the ranks, the
        whole batch's py [B], or this rank's rows' of a ``local_rows``
        batch)."""
        with span("difacto.place"):
            lb, dropped_prep = self._local(pb, need_slots=False)
        loc = Localized(uids=lb.uids, inv=lb.inv, counts=lb.ucounts,
                        valid=lb.valid)
        pull, _, C = self._route(pb, loc)
        with span("difacto.pull"):
            rows_u, _, dropped = pull(state, loc, C)
        py, metrics = worker_forward(rows_u, loc, lb.vals, lb.labels,
                                     lb.mask, fields=self._fields(lb.fields),
                                     **self.loss_kw)
        return (self._sum_metrics(metrics, dropped + dropped_prep),
                self._gather_py(py))

    # -- device-localized steps (raw ids; JAX store.py:1388-1404) ------------

    def _raw(self, ids, vals, labels, mask, fields):
        return super()._raw(self._rows(ids), self._rows(vals),
                            self._rows(labels), self._rows(mask),
                            self._rows(fields))

    def train_step(self, state, ids, vals, labels, mask, fields=None):
        """A train step on a raw GLOBAL batch (``ids`` i32 [B, L]; this
        rank's rows of a ``local_rows`` store): this rank's rows localized
        on the device into ``unique_size`` lanes, the XLA or sweep path's
        routing and push."""
        loc, vals, labels, mask, fields = self._raw(ids, vals, labels, mask,
                                                    fields)
        _count_step(loc.inv.shape[0], loc.uids.shape[0], None)
        C = self._capacity_for(loc.uids.shape[0])
        with span("difacto.pull"):
            rows_u, ctx, dropped = self._routed_pull(state, loc, C)
        grads_u, _, metrics = worker_grads(rows_u, loc, vals, labels, mask,
                                           fields=fields, **self.loss_kw)
        with span("difacto.apply"):
            state = self._routed_push(state, loc, grads_u.T, ctx, C)
        return state, self._sum_metrics(metrics, dropped + loc.overflow)

    def eval_step(self, state, ids, vals, labels, mask,
                  fields=None) -> tuple[StepMetrics, torch.Tensor]:
        loc, vals, labels, mask, fields = self._raw(ids, vals, labels, mask,
                                                    fields)
        with span("difacto.pull"):
            rows_u, _, dropped = self._routed_pull(
                state, loc, self._capacity_for(loc.uids.shape[0]))
        py, metrics = worker_forward(rows_u, loc, vals, labels, mask,
                                     fields=fields, **self.loss_kw)
        return (self._sum_metrics(metrics, dropped + loc.overflow),
                self._gather_py(py))

    def count_step(self, state, ids):
        """The feature-frequency pass over a raw GLOBAL batch (this rank's
        rows of a ``local_rows`` store): this rank's per-id counts routed
        to their owners, which add them to ``cnt`` (JAX
        ``store.py:1655-1680``)."""
        ids = _as_tensor(self._rows(ids), self.device, torch.int32)
        loc = localize(ids, self.num_rows, self.unique_size)
        S, C = self.S, self._capacity_for(loc.uids.shape[0])
        pos, ok, _ = self._routing(loc, C)
        send_ids = torch.full((S * C + 1,), -1, dtype=torch.int32,
                              device=ids.device)
        send_ids[pos] = torch.where(ok, loc.uids, -1).to(torch.int32)
        send_cnt = torch.zeros(S * C + 1, dtype=torch.float32,
                               device=ids.device)
        send_cnt[pos] = torch.where(ok, loc.counts, 0.0)
        rl, rvalid = self._receive(self.comm.all_to_all(send_ids[:S * C]))
        recv_cnt = self.comm.all_to_all(send_cnt[:S * C])
        state.cnt.index_add_(0, torch.where(rvalid, rl, 0).long(),
                             torch.where(rvalid, recv_cnt, -0.0))
        return state


def make_store(updater: FMUpdater, cfg: Config, device=None):
    """Store::Create. ``store=sharded`` gives a :class:`ShardedStore` over
    the process group (S = 1 without one), ``local`` a :class:`LocalStore`;
    ``auto`` is sharded over more than one rank (``num_shards``, else the
    group's size), as the JAX package's is over more than one device, so
    every multi-process launch shards. ``store=local`` under a
    multi-process launch raises: each process holds a shard of the table
    (the JAX package has no one-device store across processes)."""
    kind = cfg.shard.store
    if kind == "auto":
        kind = "sharded" if (cfg.shard.num_shards or Comm().size) > 1 \
            else "local"
    if kind == "sharded":
        return ShardedStore(updater, cfg, device=device)
    if process_count() > 1:
        raise ValueError(
            f"store=local under a launch of {process_count()} processes: a "
            "multi-process launch shards the table (store=sharded or auto)")
    return LocalStore(updater, cfg, device=device)
