"""Synchronous minibatch SGD learner.

Port of ``difacto_tpu/learners/sgd.py`` (reference:
``src/sgd/sgd_learner.h`` :: SGDLearner): the scheduler's job queue is
program order, and the bounded-staleness pipeline is host-side prefetch
overlapping device steps (staleness 0). Host threads
parse the data, localize and sort each batch (data/prep.py) and copy it
to the device one step ahead (utils/place.py); the main thread runs the
store's train and eval steps. With ``host_localize=0`` the raw batches
go to the device and the store localizes them there. With ``hot_rows``
a count sample of the first ``hot_count_batches`` batches builds the
frequency remap (data/remap.py) before any state exists; prep relabels
every batch by it, and checkpoints are saved in canonical rows.

Per-epoch flow mirrors RunScheduler/RunEpoch: optional feature-count pass
(tail_feature_filter), train pass over data_in, validation pass over
data_val (pull + predict only, no push), epoch-end callbacks, model save.
``DIFACTO_PROFILE`` traces the first train pass (utils/tracing.py). The
train pass marks its phases as spans on the profiler's timeline
(``difacto.epoch``, ``difacto.batch`` around each batch fetch,
``difacto.step``, ``difacto.epoch_end``; the store marks the step's
phases) and counts its batches, their wait, its blocking host reads and
the ids dropped in the ``step`` counters; :meth:`run` logs each epoch's
counter deltas after its train row.
``store=sharded`` trains through the ShardedStore: prep localizes each
batch over its row groups (data/prep.py::prep_batch_sharded), the
capacity pin moves at each epoch's end, and a one-process run's
checkpoint holds the gathered table, padding rows included, as the JAX
package's one-process branch writes it.

Several processes (the ``DIFACTO_*`` launch contract,
parallel/multihost.py; the store shards the table, one shard a process):
``batch_size`` is the global batch, and each process reads its own
byte-range parts of every file (InputSplit) at ``batch_size / P`` rows a
step, preps them as one row group at the store's fixed bucket, and steps
in lockstep with the others (:meth:`SGDLearner._lockstep`: a process whose
parts run out steps fully masked batches until all are done). The metrics
are summed over the processes; the exact AUC is taken over every
process's reservoir of ``exact_auc_cap / P`` pairs, gathered, so every
process logs the same value. Each process saves its own shard
(utils/checkpoint.py) and predicts its own rows. Every collective (the
lockstep flag, the agreed capacity, the all_to_alls, the pairs) runs on
the main thread in the same order on every process; the prep and
placement threads call none.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable

import numpy as np

from ..config import Config
from ..data.batch_iter import Batch, BatchIter
from ..data.prep import (build_sorted_slots, build_sorted_slots_sharded,
                         prep_batch, prep_batch_sharded, validate_fields)
from ..data.remap import apply_remap, build_remap, count_sample
from ..ops.metrics import exact_auc
from ..parallel.comm import allgather_host, allgather_pairs
from ..parallel.multihost import (input_part, maybe_initialize_distributed,
                                  process_count)
from ..parallel.store import ShardedStore, make_store
from ..updaters.updater import FMUpdater
from ..utils import checkpoint, tracing
from ..utils.place import place_batch
from ..utils.prefetch import MappedPrefetchIter, ThreadedIter
from ..utils.progress import Progress, Reporter
from ..utils.tracing import STEP, profile_region, span, to_host
from .step import StepMetrics, merge_metrics

log = logging.getLogger("difacto_tpu_torch")


class _Reservoir:
    """Uniform reservoir sample of (label, score) pairs (Vitter's
    Algorithm R, vectorized per batch: item ``i`` (0-based global index)
    is accepted with probability cap/(i+1) into a uniform slot — each
    item's decision is independent of the others', so a whole batch's
    draws vectorize). Until the cap is reached it is an exact copy."""

    def __init__(self, cap: int, seed: int):
        self.cap = cap
        self.n_seen = 0
        self.truncated = False
        self._rng = np.random.default_rng((seed + 1) * 0x9E3779B9)
        self._y = np.empty(cap, np.float32)
        self._p = np.empty(cap, np.float32)

    def add(self, y: np.ndarray, p: np.ndarray) -> None:
        k = len(y)
        fill = min(max(self.cap - self.n_seen, 0), k)
        if fill:
            self._y[self.n_seen : self.n_seen + fill] = y[:fill]
            self._p[self.n_seen : self.n_seen + fill] = p[:fill]
        if fill < k:
            self.truncated = True
            idx = self.n_seen + fill + np.arange(k - fill, dtype=np.int64)
            accept = self._rng.random(k - fill) < self.cap / (idx + 1)
            slots = self._rng.integers(0, self.cap, size=k - fill)
            sel = np.flatnonzero(accept)
            self._y[slots[sel]] = y[fill:][sel]
            self._p[slots[sel]] = p[fill:][sel]
        self.n_seen += k

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        n = min(self.n_seen, self.cap)
        return self._y[:n], self._p[:n]


class SGDLearner:
    """``device`` defaults to the card and raises without one unless the
    caller asks for ``"cpu"`` (utils/device.py)."""

    def __init__(self, cfg: Config, device=None):
        # the env contract's join (once a process; cli.main joins first)
        maybe_initialize_distributed()
        self._nproc = process_count()
        self.cfg = cfg
        self.updater = FMUpdater(cfg.effective_model_param())
        self.store = make_store(self.updater, cfg, device=device)
        self._sharded = isinstance(self.store, ShardedStore)
        self.device = self.store.device
        self.reporter = Reporter(cfg.learner.report_interval)
        self.epoch_callbacks: list[Callable[[int, Progress], None]] = []
        # reference DataStore: cache processed batches across epochs
        self._batch_cache: dict[str, tuple[bool, list]] = {}
        self._epoch = 0
        self._resume_step = 0  # batches already consumed in self._epoch
        self._host_localize = bool(cfg.data.host_localize)
        # hot/cold split: the remap exists before any state is made or
        # model_in is placed (the store permutes canonical rows by it)
        self._hot_remap = None
        if self.store.hot_rows:
            self._build_remap()
        if cfg.learner.model_in:
            self.state, meta = checkpoint.load_for_store(
                cfg.learner.model_in, self.store
            )
            self._epoch = int(meta.get("epoch", 0))
            self._resume_step = int(meta.get("step", 0))
            log.info(
                "loaded model from %s (epoch %d, step %d)",
                cfg.learner.model_in, self._epoch, self._resume_step,
            )
        else:
            self.state = self.store.init_state(cfg.data.seed)

    def _build_remap(self) -> None:
        """The per-run frequency remap from a count sample of the training
        data's first ``hot_count_batches`` batches (JAX ``sgd.py:93-118``)."""
        H, N = self.store.hot_rows, self.store.num_rows
        cnt = count_sample(
            self._iter(self.cfg.data.data_in, shuffle=False, localize=False),
            N, self.cfg.shard.hot_count_batches)
        self._hot_remap = build_remap(cnt, H)
        self.store.set_remap(self._hot_remap)
        head = cnt[self._hot_remap < H].sum()
        log.info("hot remap built: head %d of %d rows (%.1f%% of sampled "
                 "slots)", H, N, 100.0 * head / max(cnt.sum(), 1))

    # -- data ---------------------------------------------------------------

    def _iter(self, uri: str, shuffle: bool, localize: bool = True,
              epoch: int = 0, sorted_slots: bool = False):
        """Batches of ``uri``: raw host Batches when ``localize`` is
        false (the count pass), else batches on the device: prepped, with
        their sorted slots when ``sorted_slots`` (the train pass), or raw
        with ``host_localize=0`` (the store localizes them). Several
        processes step them in lockstep."""
        prep = (self._prep_fn(sorted_slots)
                if localize and self._host_localize else None)

        def empty():
            """A fully masked batch in the form of the pass's items."""
            b = self._empty_batch()
            if not localize:
                return b
            return place_batch(prep(b) if prep else self._check_raw(b),
                               self.device)

        return self._lockstep(
            self._stream(uri, shuffle, localize, epoch, sorted_slots, prep),
            empty)

    def _empty_batch(self) -> Batch:
        """A batch of this process's rows with no ids and mask 0."""
        d = self.cfg.data
        bs, L = d.batch_size // self._nproc, d.max_nnz_per_row
        return Batch(np.full((bs, L), -1, np.int32),
                     np.zeros((bs, L), np.float32), np.zeros(bs, np.float32),
                     np.zeros(bs, np.float32),
                     fields=(np.zeros((bs, L), np.int32)
                             if d.data_format == "libffm" else None))

    def _lockstep(self, it, make_empty):
        """The items of ``it`` in lockstep across processes (JAX
        ``SGDLearner._lockstep``): at each step every process says by a
        host allgather whether it still has an item; the pass ends when
        none has, and a process whose items ran out yields ``make_empty()``
        meanwhile, so every process runs the same steps and collectives.
        Runs on the consumer's (main) thread. One process: ``it``."""
        if self._nproc == 1:
            return it

        def gen():
            src, done, empty = iter(it), False, None
            while True:
                item = None if done else next(src, None)
                done = item is None
                if not allgather_host(np.array(not done, np.int32)).any():
                    return
                if item is None:
                    if empty is None:
                        empty = make_empty()
                    item = empty
                yield item

        return gen()

    def _stream(self, uri: str, shuffle: bool, localize: bool, epoch: int,
                sorted_slots: bool, prep):
        """This process's batches of ``uri`` (see :meth:`_iter`), before
        the lockstep."""
        d = self.cfg.data
        cache_key = self._cache_key(uri, shuffle, localize, sorted_slots)
        if cache_key is not None and cache_key in self._batch_cache:
            placed, items = self._batch_cache[cache_key]
            return iter(items) if placed else self._place_iter(iter(items))
        if cache_key is not None:
            # the cache fixes one batch order for every epoch (the
            # reference's DataStore reuses the same compacted batches too)
            epoch = 0
        # the InputSplit contract: this process's byte-range parts of every
        # file, at its share of the global batch (the store checked that
        # the processes divide it)
        parts, num_parts = input_part(d.num_parts_per_file)
        src = iter(BatchIter(
            uri,
            batch_size=d.batch_size // self._nproc,
            max_nnz=d.max_nnz_per_row,
            num_bits=d.num_bits,
            data_format=d.data_format,
            part_index=parts,
            num_parts=num_parts,
            shuffle=shuffle and d.shuffle,
            # epoch-dependent seed: each epoch must shuffle differently AND
            # a resumed run must reproduce the interrupted epoch's order
            seed=d.seed + epoch,
            batch_workers=d.batch_workers,
        ))
        if not localize:
            return ThreadedIter(src, depth=4)
        if prep is not None:
            out = self._prep_iter(src, prep)
        else:
            out = ThreadedIter(map(self._check_raw, src), depth=4)
        if cache_key is None:
            return self._place_iter(out)
        # fill the cache lazily so epoch 0 still streams; complete at
        # exhaustion. cache_on_device caches the PLACED batches, so later
        # epochs re-read device memory instead of re-copying from the host
        place_first = d.cache_on_device
        stream = self._place_iter(out) if place_first else out

        def caching():
            acc = []
            for item in stream:
                acc.append(item)
                yield item
            self._batch_cache[cache_key] = (place_first, acc)

        return caching() if place_first else self._place_iter(caching())

    def _cache_key(self, uri: str, shuffle: bool, localize: bool,
                   sorted_slots: bool) -> str | None:
        """The batch cache's key of a pass: it covers everything that
        changes batch content or order; the raw count-pass stream is never
        cached (it runs once)."""
        if not (self.cfg.data.cache_batches and localize):
            return None
        return f"{uri}|{shuffle}|{sorted_slots}"

    def _check_raw(self, b):
        """A raw batch's libffm fields, range-checked on the host before
        placement (the store checks host arrays only)."""
        if self.cfg.expects_fields():
            validate_fields(b.fields, self.cfg.model.num_fields)
        return b

    def _prep_fn(self, sorted_slots: bool):
        """The host prep of one raw batch (run by the prep workers; it
        calls no collective)."""
        num_rows = self.store.num_rows
        min_ub = self.cfg.shard.unique_size or None
        # FFM's sorted backward gathers its per-slot payload by the sort
        # permutation (SortedSlots.slot_sorted)
        with_slots = self.cfg.learner.loss == "ffm"
        # explicit libffm fields are range-checked here, on the host; the
        # batch carries them to the device, and a cached batch keeps them
        nf = self.cfg.model.num_fields if self.cfg.expects_fields() else 0
        # the hot/cold split: relabel by the remap, split the buckets
        remap, hot = self._hot_remap, self.store.hot_rows
        # LocalStore's sorted slots in the compact form on every sorted
        # path, kernel=pairs too (the JAX learner compacts on kernel=xla
        # only; its store takes compact batches on both)
        compact = self.cfg.data.cache_compact

        def prep(b):
            if self._sharded:  # one row group a rank (JAX sgd.py:197-245)
                # a process's own rows are one group at the store's fixed
                # bucket: every process has the same shapes, and the same
                # batches drop the same ids (counted)
                st = self.store
                pb = prep_batch_sharded(
                    b, num_rows, 1 if st.local_rows else st.S,
                    fixed_ub=st.unique_size if st.local_rows else None,
                    num_fields=nf, num_shards_global=st.S)
                if sorted_slots:
                    pb.sorted_slots = build_sorted_slots_sharded(
                        pb, with_slots=with_slots)
                return pb
            pb = prep_batch(b, num_rows, min_ub=min_ub, num_fields=nf,
                            remap=remap, hot_rows=hot)
            if sorted_slots:
                pb.sorted_slots = build_sorted_slots(
                    pb.inv, pb.vals, with_slots=with_slots, compact=compact)
            return pb

        return prep

    def _prep_iter(self, src, prep):
        """Prepped host batches of a raw batch stream, from a pool of prep
        workers."""
        d = self.cfg.data
        # prep_workers=0 -> auto: leave cores for the parse thread, the
        # batchify pool and the main thread
        pw = d.prep_workers or min(4, max(1, (os.cpu_count() or 4) - 2))
        if pw > 1:
            return MappedPrefetchIter(ThreadedIter(src, depth=4), prep,
                                      workers=pw)
        return ThreadedIter(map(prep, src), depth=4)

    def _place_iter(self, it):
        """Copy batches to the device one step ahead of consumption."""
        return ThreadedIter((place_batch(b, self.device) for b in it),
                            depth=2)

    # -- passes (reference: SGDLearner::RunEpoch / IterateData) -------------

    def count_pass(self) -> None:
        """Feature-frequency pass before training (reference: the
        kFeaCount push pass enabling tail_feature_filter)."""
        n = 0
        for batch in self._iter(self.cfg.data.data_in, shuffle=False,
                                localize=False):
            ids = batch.ids
            if self._hot_remap is not None:
                # the split state is addressed in remapped rows; the raw
                # count stream is relabeled as prep relabels
                ids = apply_remap(ids, self._hot_remap)
            args = self.store.shard_batch(ids, batch.vals,
                                          batch.labels, batch.mask,
                                          batch.fields)
            self.state = self.store.count_step(self.state, args[0])
            n += 1
        log.info("count pass done (%d batches)", n)

    def train_epoch(self, epoch: int) -> Progress:
        cfg = self.cfg
        prog = Progress()
        self.reporter.reset()
        acc = None
        step = 0
        skip = self._resume_step if epoch == self._epoch else 0
        if skip:
            log.info("resuming epoch %d at step %d", epoch, skip)
        uri, sorted_slots = cfg.data.data_in, self.store.sorted_grads
        source = ("batches_replayed"
                  if self._cache_key(uri, True, True, sorted_slots)
                  in self._batch_cache else "batches_streamed")
        debug = log.isEnabledFor(logging.DEBUG)
        # the sorted slots only where the store's backward reads them
        with profile_region(f"train_epoch_{epoch}"), span("difacto.epoch"):
            batches = iter(self._iter(uri, shuffle=True, epoch=epoch,
                                      sorted_slots=sorted_slots))
            while True:
                t0 = time.perf_counter()
                with span("difacto.batch"):
                    batch = next(batches, None)
                STEP["batch_wait_s"] += time.perf_counter() - t0
                if batch is None:
                    break
                STEP[source] += 1
                if step < skip:
                    step += 1
                    continue
                before = tracing.counters() if debug else None
                with span("difacto.step"):
                    self.state, metrics = self._train_step(batch)
                    acc = (metrics if acc is None
                           else merge_metrics(acc, metrics))
                if debug:
                    log.debug("epoch %d step %d counters: %s", epoch, step,
                              tracing.format_counters(
                                  tracing.delta(before)))
                step += 1
                if (self.reporter.interval > 0
                        and step % self.reporter.interval == 0):
                    self._fold(prog, acc)
                    acc = None
                    self.reporter.maybe_report(step, prog,
                                               prefix=f"epoch {epoch} ")
                si = cfg.learner.save_interval_steps
                if cfg.learner.model_out and si > 0 and step % si == 0:
                    self._save({"epoch": epoch, "step": step})
            with span("difacto.epoch_end"):
                if acc is not None:
                    self._fold(prog, acc)
                if self._sharded:
                    # the epoch's end: later batches take one tight
                    # all_to_all capacity (ShardedStore.pin_capacity)
                    self.store.pin_capacity()
                st = self.store.stats(self.state)
        prog.nnz_w = float(st["nnz_w"])
        prog.nnz_V = float(st["nnz_V"])
        return prog

    def _train_step(self, batch):
        if self._host_localize:
            return self.store.train_step_prepped(self.state, batch)
        return self.store.train_step(self.state, batch.ids, batch.vals,
                                     batch.labels, batch.mask, batch.fields)

    def _eval_step(self, batch):
        if self._host_localize:
            return self.store.eval_step_prepped(self.state, batch)
        return self.store.eval_step(self.state, batch.ids, batch.vals,
                                    batch.labels, batch.mask, batch.fields)

    def _save(self, meta: dict) -> str | None:
        """Checkpoint the state in canonical rows (a hot/cold state by the
        run's remap). A sharded state: under several processes each saves
        its own rows (no process gathers the table); else the gathered
        table, padding rows included, written by rank 0. Returns the file
        this process wrote, if any."""
        st, out = self.store, self.cfg.learner.model_out
        if not self._sharded:
            return checkpoint.save(out, self.state, meta,
                                   remap_lut=st.hot_lut)
        if st.local_rows:
            return checkpoint.save(out, self.state, meta,
                                   shard=(st.lo, st.num_rows))
        state = st.gather_state(self.state)  # a collective
        return checkpoint.save(out, state, meta) if st.rank == 0 else None

    def eval_pass(self, uri: str) -> Progress:
        prog = Progress()
        acc = None
        # (label, score) pairs are host-collected for the exact AUC up to
        # a cap; past it a uniform RESERVOIR sample of cap pairs replaces
        # the collection. The streaming binned AUC always covers the full
        # pass.
        # several processes: a reservoir of cap / P pairs each, gathered
        cap = self.cfg.learner.exact_auc_cap
        res = (_Reservoir(max(cap // self._nproc, 1), self.cfg.data.seed)
               if cap > 0 else None)
        with span("difacto.eval"):
            for batch in self._iter(uri, shuffle=False):
                metrics, py = self._eval_step(batch)
                acc = metrics if acc is None else merge_metrics(acc, metrics)
                if res is not None:
                    keep = to_host(batch.mask) > 0
                    res.add(to_host(batch.labels)[keep], to_host(py)[keep])
            if acc is not None:
                self._fold(prog, acc)
        y = p = None
        if res is not None and (self._nproc > 1 or res.n_seen):
            y, p = allgather_pairs(*res.sample())  # every process calls it
        if y is not None and len(y):
            prog.exact_auc = exact_auc(y, p)
            prog.exact_auc_truncated = res.truncated
            prog.exact_auc_n = len(y)
            prog.exact_auc_of = int(prog.num_examples)
            if res.truncated:
                log.info(
                    "exact AUC computed on a uniform reservoir sample of %d "
                    "of %d examples (cap %d, config knob exact_auc_cap); the "
                    "streaming binned `auc` column covers the full pass "
                    "exactly (error bound %.2e)",
                    len(y), prog.exact_auc_of, cap, prog.auc_error_bound,
                )
        return prog

    @staticmethod
    def _fold(prog: Progress, acc: StepMetrics) -> None:
        m = StepMetrics(*(to_host(t) for t in acc))
        prog.merge(
            Progress(
                num_examples=float(m.examples),
                logloss_sum=float(m.logloss_sum),
                correct_sum=float(m.correct_sum),
                label_sum=float(m.label_sum),
                pred_sum=float(m.pred_sum),
                auc_hist=np.asarray(m.auc_hist, dtype=np.float64),
            )
        )
        dropped = int(m.dropped_ids)
        if dropped:
            STEP["ids_dropped"] += dropped
            log.warning("routing capacity overflow: %d ids dropped", dropped)

    # -- driver (reference: SGDLearner::RunScheduler) -----------------------

    def run(self) -> Progress:
        cfg = self.cfg
        if cfg.model.tail_feature_filter > 0 and not cfg.learner.model_in:
            self.count_pass()
        last = Progress()
        for epoch in range(self._epoch, cfg.learner.max_num_epochs):
            before = tracing.counters()
            tr = self.train_epoch(epoch)
            log.info("epoch %d train: %s", epoch, tr.row())
            log.info("epoch %d counters: %s", epoch,
                     tracing.format_counters(tracing.delta(before)))
            if cfg.data.data_val:
                va = self.eval_pass(cfg.data.data_val)
                auc = getattr(va, "exact_auc", None) or va.auc
                sampled = (
                    " (over %d of %d sampled)" % (va.exact_auc_n, va.exact_auc_of)
                    if va.exact_auc_truncated else ""
                )
                log.info(
                    "epoch %d valid: %s exact_auc %.6f%s",
                    epoch, va.row(), auc, sampled,
                )
                last = va
            else:
                last = tr
            for cb in self.epoch_callbacks:
                cb(epoch, last)
            if cfg.learner.model_out and (
                (epoch + 1) % cfg.learner.save_interval_epochs == 0
                or epoch + 1 == cfg.learner.max_num_epochs
            ):
                path = self._save({"epoch": epoch + 1, "step": 0})
                if path:
                    log.info("saved model to %s", path)
        return last

    def predict(self, uri: str) -> tuple[np.ndarray, np.ndarray]:
        """Batch prediction: returns (scores, labels) for all rows of this
        process's parts, in their order (reference: the validation/pred
        flow with model_in + no training)."""
        pys, ys = [], []
        with span("difacto.eval"):
            for batch in self._iter(uri, shuffle=False):
                _, py = self._eval_step(batch)
                keep = to_host(batch.mask) > 0
                pys.append(to_host(py)[keep])
                ys.append(to_host(batch.labels)[keep])
        if not pys:
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        return np.concatenate(pys), np.concatenate(ys)
