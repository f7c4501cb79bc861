"""Host-side batch localization (dedup) and slot sorting for the prep
workers.

Copy of the single-table part of ``difacto_tpu/data/prep.py``. The
reference runs its Localizer (``src/data/localizer.h``) on worker CPU
threads, overlapped with training; so does this module, in the learner's
prep thread pool. The dedup shrinks the unique-lane count to the batch's
actual unique count, rounded up a bucket ladder, and every downstream
sparse cost (the pull, the segment sum, the apply) scales with it.

Past ``_LUT_MAX_ROWS`` table rows a batch of at least 4096 slots goes to
the native radix localizer (data/_native.py), as in the JAX package.
``prep_batch(remap=, hot_rows=)`` relabels the ids by the frequency
remap (data/remap.py) before the dedup and packs the uniques into a hot
and a cold bucket (the hot/cold split, ``HotColdFMState``).
``prep_batch_sharded`` localizes a batch for the sharded store: each of
its S row groups on its own, stacked (``ShardPreppedBatch``).
``build_sorted_slots`` builds no Pallas schedule (SegMeta, PairMeta),
and the sharded prep no per-owner pair schedule (``ShardPairMetas``,
``build_shard_pair_metas``): those are Mosaic addressing artefacts the
Hopper kernels do not need.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..ops.segsum import pad_sorted_stream
from .batch_iter import Batch

# per-thread id->lane scratch tables (see _localize_ids): a fresh np.empty
# per batch pays its page faults every time; a reused buffer does not.
# Thread-local because prep fans out to a worker pool
# (utils/prefetch.py::MappedPrefetchIter).
_TLS = threading.local()

# direct id->lane LUTs are capped: beyond 2^24 rows a per-thread table
# would cost 4 B x rows x prep_workers of address space — above the cap
# the inverse falls back to a searchsorted over the batch's own sorted
# uniques (memory O(batch), slower)
_LUT_MAX_ROWS = 1 << 24
# ... and past the cap a batch of at least this many slots takes the
# native radix localizer, whose memory is O(batch) at any table size
_NATIVE_MIN_SLOTS = 4096


def _lut_for(num_rows: int) -> np.ndarray:
    d = getattr(_TLS, "luts", None)
    if d is None:
        d = _TLS.luts = {}
    lut = d.get(num_rows)
    if lut is None:
        lut = d[num_rows] = np.empty(num_rows + 1, np.int32)
    return lut


def validate_fields(fields: np.ndarray | None, num_fields: int) -> None:
    """Host-side libffm field-range check (the loss clips field ids into
    range, so an out-of-range id — num_fields set too small, or a
    malformed file — would otherwise train a silently wrong model). Runs
    here, where fields are still host numpy: the learner places batches
    on the device before the store sees them."""
    if num_fields <= 0:
        return
    if fields is None:
        raise ValueError(
            "num_fields > 0 but this batch carries no field ids "
            "(use data_format=libffm)"
        )
    if isinstance(fields, np.ndarray) and fields.size:
        fmax = int(fields.max())
        if fmax >= num_fields:
            raise ValueError(
                f"libffm field id {fmax} out of range: num_fields="
                f"{num_fields} (fields must be in [0, num_fields))"
            )


# unique-lane bucket ladder: actual unique count is padded up to one of
# these (few distinct sizes => few distinct allocation shapes)
DEFAULT_BUCKETS = (1 << 14, 1 << 15, 1 << 16, 1 << 17, 17 << 13, 3 << 16,
                   1 << 18, 3 << 17, 1 << 19, 3 << 18, 1 << 20)


@dataclass
class SortedSlots:
    """The batch's nnz slots reordered by unique lane, so per-key gradient
    sums become segment sums over a monotone stream (ops/segsum.py). All
    arrays are padded to a tile multiple; pad slots carry x == 0 and
    repeat the last real lane (they add nothing)."""

    x_sorted: np.ndarray    # f32 [BLp] vals in sorted-slot order
    bidx: np.ndarray        # i32 [BLp] example index per sorted slot
    inv_sorted: np.ndarray  # i32 [BLp] monotone unique lanes
    # the flat [B*L] slot of each sorted slot (the sort permutation; pads
    # carry 0 and are masked by position). Built for loss=ffm only: its
    # per-slot gradient has no per-key factoring, so the sorted backward
    # gathers the batch-space gradient rows by it
    # (learners/step.py::worker_grads_sorted).
    slot_sorted: np.ndarray | None = None


@dataclass
class PreppedBatch:
    """A Batch plus its host-computed localization. Arrays are NumPy on
    the host and torch tensors once placed (utils/place.py)."""

    vals: np.ndarray     # f32 [B, L]
    labels: np.ndarray   # f32 [B]
    mask: np.ndarray     # f32 [B]
    uids: np.ndarray     # i32 [Ub] sorted unique hashed ids; sentinel N pad
    ucounts: np.ndarray  # f32 [Ub]
    inv: np.ndarray      # i32 [B*L] row-major slot -> unique lane
    valid: np.ndarray    # bool [Ub]
    sorted_slots: SortedSlots | None = None
    fields: np.ndarray | None = None  # i32 [B, L] libffm fields (loss=ffm)
    fields_checked: bool = False  # range-validated at prep time (host)
    # hot/cold split (prep_batch with a remap): ``uids`` is a hot bucket
    # (remapped ids < hot_rows, pad sentinel hot_rows) followed by a cold
    # bucket (pad sentinel num_rows); these are copies of its two parts
    uids_hot: np.ndarray | None = None   # i32 [Ch]
    uids_cold: np.ndarray | None = None  # i32 [Cc] global remapped ids

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    # pathological: exact size, 128-aligned like the ladder
    return (n + 127) // 128 * 128


def _localize_ids(ids: np.ndarray, num_rows: int):
    """Dedup one batch's padded ids (PAD_ID=-1 -> sentinel num_rows,
    which sorts last). Returns (uids, inv, counts, has_sentinel, n_real).

    Past ``_LUT_MAX_ROWS`` rows a batch of ``_NATIVE_MIN_SLOTS`` or more
    goes to the native radix localizer when it is built (data/_native.py
    counts the engine: ``localize_native``, or ``localize_searchsorted``
    for the NumPy engine past the cap); every other batch, and that one
    without the native library, to :func:`_localize_numpy`. Both give the
    same arrays."""
    flat = ids.reshape(-1)
    if flat.dtype != np.int32:
        flat = flat.astype(np.int32)
    if len(flat) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64), False, 0)
    if num_rows > _LUT_MAX_ROWS and len(flat) >= _NATIVE_MIN_SLOTS:
        from . import _native

        if _native.available():
            _native.count("localize_native")
            uids, inv, counts = _native.localize(flat, num_rows)
        else:
            _native.count("localize_searchsorted")
            uids, inv, counts = _localize_numpy(flat, num_rows)
    else:
        uids, inv, counts = _localize_numpy(flat, num_rows)
    has_sentinel = bool(len(uids)) and uids[-1] == num_rows
    n_real = len(uids) - int(has_sentinel)
    return uids, inv, counts, has_sentinel, n_real


def _localize_numpy(flat: np.ndarray, num_rows: int):
    """The NumPy engine of :func:`_localize_ids` on a non-empty i32 [n]:
    (uids, inv, counts). numpy's int32 ``np.sort`` is a radix sort while
    ``np.unique``'s argsort-based inverse is much slower, so the inverse
    is rebuilt from a direct id->lane lookup table instead. The table is
    ``np.empty`` (no zeroing; only touched pages materialize); past
    ``_LUT_MAX_ROWS`` rows the inverse is a searchsorted over the
    batch's sorted uniques instead."""
    keys = np.where(flat < 0, np.int32(num_rows), flat)
    sk = np.sort(keys)  # radix for int32
    first = np.empty(len(sk), bool)
    first[0] = True
    np.not_equal(sk[1:], sk[:-1], out=first[1:])
    idx = np.flatnonzero(first)
    uids = sk[idx]
    counts = np.diff(np.append(idx, len(sk)))
    if num_rows <= _LUT_MAX_ROWS:
        lut = _lut_for(num_rows)
        lut[uids] = np.arange(len(uids), dtype=np.int32)
        inv = lut[keys]
    else:
        inv = np.searchsorted(uids, keys).astype(np.int32)
    return uids, inv, counts


def _pack_localized(uids, inv, counts, has_sentinel, n_real, num_rows, ub):
    """Pad/truncate one batch's unique set to exactly ``ub`` lanes.

    When the real unique count does not fit (fixed bucket smaller than
    the batch's uniques), the overflowing ids are DROPPED and counted:
    lane ub-1 is reserved as an invalid junk lane and every slot of a
    dropped id (and of input padding) points there. Returns
    (uids, counts, inv, valid, n_dropped)."""
    n_keep = min(n_real, ub)
    if (has_sentinel or n_keep < n_real) and n_keep == ub:
        n_keep = ub - 1  # reserve a junk lane for sentinel/dropped slots
    dropped = n_real - n_keep
    u_out = np.full(ub, num_rows, np.int32)
    c_out = np.zeros(ub, np.float32)
    u_out[:n_keep] = uids[:n_keep]
    c_out[:n_keep] = counts[:n_keep]
    valid = np.zeros(ub, bool)
    valid[:n_keep] = True
    inv = inv.astype(np.int32)
    if has_sentinel or dropped:
        inv = np.where(inv >= n_keep, ub - 1, inv)
    return u_out, c_out, inv, valid, dropped


# cold-bucket granularity of the hot/cold split (the JAX package's: its
# big-table scatter paid for every cold lane, pads included, so the cold
# bucket rounds finely and the slop of the total ladder lands in the hot
# bucket)
_COLD_GRAN = 2048


def _pack_localized_split(uids, inv, counts, n_real, num_rows, hot_rows,
                          buckets, min_ub):
    """Split-pack one batch's sorted (remapped) uniques into [hot | cold]
    buckets. Returns (uids, counts, inv, valid, ch). The sentinel entry
    (position n_real) needs no case of its own: shifted like the cold
    entries it lands on the first cold pad, an invalid lane because the
    cold bucket always holds more lanes than cold ids."""
    n_hot = int(np.searchsorted(uids[:n_real], hot_rows, side="left"))
    n_cold = n_real - n_hot
    cc = max(-(-(n_cold + 1) // _COLD_GRAN) * _COLD_GRAN, _COLD_GRAN)
    floor = (min_ub + 127) // 128 * 128 if min_ub else 0
    ub = max(bucket_for(n_hot + cc, buckets), floor)
    ch = ub - cc
    u_out = np.full(ub, num_rows, np.int32)
    u_out[:n_hot] = uids[:n_hot]
    u_out[n_hot:ch] = hot_rows  # hot pad: out of range for the hot table
    u_out[ch:ch + n_cold] = uids[n_hot:n_real]
    c_out = np.zeros(ub, np.float32)
    c_out[:n_hot] = counts[:n_hot]
    c_out[ch:ch + n_cold] = counts[n_hot:n_real]
    valid = np.zeros(ub, bool)
    valid[:n_hot] = True
    valid[ch:ch + n_cold] = True
    inv = inv.astype(np.int32)
    # hot lanes stay; cold ones (and the sentinel's) move past the hot pads
    inv = np.where(inv < n_hot, inv, inv - n_hot + ch)
    return u_out, c_out, inv, valid, ch


def prep_batch(
    batch: Batch, num_rows: int, buckets=DEFAULT_BUCKETS,
    min_ub: int | None = None, num_fields: int = 0,
    remap: np.ndarray | None = None, hot_rows: int = 0,
) -> PreppedBatch:
    """Localization of one padded batch (reference: Localizer::Compact —
    sort, dedup, rewrite indices, count).

    ``min_ub`` floors the unique bucket (config ``unique_size``); a rare
    larger batch still gets the next bucket up. ``num_fields`` > 0
    validates explicit libffm field ids here, the last point where they
    are still numpy; the batch's fields travel with it either way.

    ``remap``/``hot_rows``: the frequency remap (data/remap.py) relabels
    the ids before the dedup, and the uniques are packed into a hot and a
    cold bucket (``uids_hot``, ``uids_cold``); the batch's uniques are then
    unique within each bucket, not across them (a hot pad carries
    ``hot_rows``, which is also the first cold row)."""
    validate_fields(batch.fields, num_fields)
    ids = batch.ids
    if remap is not None:
        from .remap import apply_remap

        assert hot_rows > 0, "remap without hot_rows has no effect"
        ids = apply_remap(ids, remap)
    uids, inv, counts, has_sentinel, n_real = _localize_ids(ids, num_rows)
    if remap is not None:
        u_out, c_out, inv, valid, ch = _pack_localized_split(
            uids, inv, counts, n_real, num_rows, hot_rows, buckets, min_ub)
        return PreppedBatch(
            vals=batch.vals, labels=batch.labels, mask=batch.mask,
            uids=u_out, ucounts=c_out, inv=inv.reshape(-1), valid=valid,
            fields=batch.fields, fields_checked=num_fields > 0,
            uids_hot=u_out[:ch].copy(), uids_cold=u_out[ch:].copy())
    # the bucket must leave a junk lane for sentinel slots when present
    need = max(n_real + int(has_sentinel), 1)
    floor = (min_ub + 127) // 128 * 128 if min_ub else 0
    ub = max(bucket_for(need, buckets), floor)
    u_out, c_out, inv, valid, dropped = _pack_localized(
        uids, inv, counts, has_sentinel, n_real, num_rows, ub
    )
    assert dropped == 0  # bucket_for always fits (falls back to exact size)
    return PreppedBatch(
        vals=batch.vals,
        labels=batch.labels,
        mask=batch.mask,
        uids=u_out,
        ucounts=c_out,
        inv=inv.reshape(-1),
        valid=valid,
        fields=batch.fields,
        fields_checked=num_fields > 0,
    )


def build_sorted_slots(inv: np.ndarray, vals: np.ndarray,
                       with_slots: bool = False) -> SortedSlots:
    """SortedSlots for one prepped batch (``inv`` [B*L], ``vals`` [B, L]):
    a stable argsort of ``inv`` — host work the reference also did on
    worker CPUs — run in the prep workers, overlapped with device steps.
    ``with_slots`` also keeps the permutation (``slot_sorted``, FFM). It
    reads the lanes only, never the ids, so a split batch (whose ids
    repeat across the buckets) sorts as any other."""
    L = vals.shape[1]
    perm = np.argsort(inv, kind="stable")
    inv_s = pad_sorted_stream(inv[perm].astype(np.int32, copy=False))
    blp, bl = inv_s.shape[0], perm.shape[0]
    x = np.zeros(blp, np.float32)
    x[:bl] = vals.reshape(-1)[perm]
    bidx = np.zeros(blp, np.int32)
    bidx[:bl] = (perm // L).astype(np.int32)
    slot_s = None
    if with_slots:
        slot_s = np.zeros(blp, np.int32)
        slot_s[:bl] = perm
    return SortedSlots(x_sorted=x, bidx=bidx, inv_sorted=inv_s,
                       slot_sorted=slot_s)


@dataclass
class ShardPreppedBatch:
    """A batch localized for the sharded store (parallel/store.py ::
    ShardedStore): the batch's rows split into ``num_shards`` contiguous
    row groups, one per rank, each deduplicated on its own, and the
    per-group unique sets stacked flat, so rank s reads lanes
    ``[s*ub, (s+1)*ub)``. All groups share one bucket size ``ub`` (the
    largest group's, up the bucket ladder). Port of
    ``difacto_tpu/data/prep.py::ShardPreppedBatch``."""

    vals: np.ndarray     # f32 [B, L]     (global batch layout, row-split)
    labels: np.ndarray   # f32 [B]
    mask: np.ndarray     # f32 [B]
    uids: np.ndarray     # i32 [S*ub]     per-group sorted uniques, stacked
    ucounts: np.ndarray  # f32 [S*ub]
    inv: np.ndarray      # i32 [B*L]      slot -> unique lane (group-local)
    valid: np.ndarray    # bool [S*ub]
    dropped: np.ndarray  # f32 [S]        unique ids dropped by a fixed bucket
    ub: int
    num_shards: int
    fields: np.ndarray | None = None  # i32 [B, L] libffm fields (loss=ffm)
    sorted_slots: SortedSlots | None = None  # stacked [S, ...] per group
    fields_checked: bool = False  # range-validated at prep time (host)
    # the largest (source, owner) bucket fill (shard_bucket_fills), taken
    # here on the host so that the store's capacity needs no device sync
    max_fill: int = 0

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


def shard_bucket_fills(pb: ShardPreppedBatch, num_rows: int,
                       num_shards_global: int | None = None) -> np.ndarray:
    """i64 [G, S] routing matrix: fills[src, owner] = how many of group
    ``src``'s valid unique ids the store routes to rank ``owner`` (rows
    ``[owner * rps, (owner+1) * rps)``, ``rps = num_rows // S``). The
    sharded store sizes its all_to_all capacity from the largest. ``G`` is
    the batch's row groups; ``S``, the owners, is ``num_shards_global``
    (a process's batch of its own rows: one group, S owners) or G."""
    G, ub = pb.num_shards, pb.ub
    S = num_shards_global or G
    rows_per_shard = num_rows // S
    uids = pb.uids.reshape(G, ub).astype(np.int64)
    bounds = np.arange(S + 1, dtype=np.int64) * rows_per_shard
    fills = np.empty((G, S), np.int64)
    for s in range(G):
        n_valid = int(np.searchsorted(uids[s], num_rows, side="left"))
        lo = np.searchsorted(uids[s][:n_valid], bounds, side="left")
        fills[s] = lo[1:] - lo[:-1]
    return fills


def prep_batch_sharded(batch: Batch, num_rows: int, num_shards: int,
                       buckets=DEFAULT_BUCKETS, fixed_ub: int | None = None,
                       num_fields: int = 0,
                       num_shards_global: int | None = None
                       ) -> ShardPreppedBatch:
    """Per-group host localization (see :class:`ShardPreppedBatch`).
    ``fixed_ub`` pins the bucket size; ids past it are dropped and counted
    in ``dropped`` (they surface as ``StepMetrics.dropped_ids``). A process
    of a multi-process run preps its own rows as one group
    (``num_shards=1``) for ``num_shards_global`` owners, at the store's
    fixed bucket, so that every process has the same shapes."""
    validate_fields(batch.fields, num_fields)
    b, l = batch.ids.shape
    if b % num_shards:
        raise ValueError(f"num_shards {num_shards} must divide the batch's "
                         f"{b} rows")
    bs = b // num_shards
    per = [_localize_ids(batch.ids[s * bs:(s + 1) * bs], num_rows)
           for s in range(num_shards)]
    if fixed_ub is None:
        need = max(max(n_real + int(has_s), 1)
                   for *_, has_s, n_real in per)
        ub = bucket_for(need, buckets)
    else:
        ub = fixed_ub
    u_st = np.empty((num_shards, ub), np.int32)
    c_st = np.empty((num_shards, ub), np.float32)
    inv_st = np.empty((num_shards, bs * l), np.int32)
    v_st = np.empty((num_shards, ub), bool)
    d_st = np.empty(num_shards, np.float32)
    for s, (uids, inv, counts, has_s, n_real) in enumerate(per):
        u_st[s], c_st[s], inv_st[s], v_st[s], d_st[s] = _pack_localized(
            uids, inv, counts, has_s, n_real, num_rows, ub)
    pb = ShardPreppedBatch(
        vals=batch.vals, labels=batch.labels, mask=batch.mask,
        uids=u_st.reshape(-1), ucounts=c_st.reshape(-1),
        inv=inv_st.reshape(-1), valid=v_st.reshape(-1), dropped=d_st,
        ub=ub, num_shards=num_shards, fields=batch.fields,
        fields_checked=num_fields > 0)
    pb.max_fill = int(shard_bucket_fills(pb, num_rows,
                                         num_shards_global).max())
    return pb


def build_sorted_slots_sharded(pb: ShardPreppedBatch,
                               with_slots: bool = False) -> SortedSlots:
    """Per-group SortedSlots of a ShardPreppedBatch, stacked [S, ...]:
    rank s's sorted backward reads row s. Host work with no collective
    (the per-key sums happen before routing)."""
    S = pb.num_shards
    B, L = pb.vals.shape
    bs = B // S
    parts = [build_sorted_slots(pb.inv.reshape(S, bs * L)[s],
                                pb.vals[s * bs:(s + 1) * bs],
                                with_slots=with_slots) for s in range(S)]
    return SortedSlots(
        x_sorted=np.stack([p.x_sorted for p in parts]),
        bidx=np.stack([p.bidx for p in parts]),
        inv_sorted=np.stack([p.inv_sorted for p in parts]),
        slot_sorted=(np.stack([p.slot_sorted for p in parts])
                     if with_slots else None))
