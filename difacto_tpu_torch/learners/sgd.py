"""Synchronous minibatch SGD learner on one device.

Port of ``difacto_tpu/learners/sgd.py`` (reference:
``src/sgd/sgd_learner.h`` :: SGDLearner), single process: the scheduler's
job queue is program order, and the bounded-staleness pipeline is
host-side prefetch overlapping device steps (staleness 0). Host threads
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
``DIFACTO_PROFILE`` traces the first train pass (utils/tracing.py).
Multi-process lockstep waits for the sharded store (ROADMAP A9).
"""

from __future__ import annotations

import logging
import os
from typing import Callable

import numpy as np

from ..config import Config
from ..data.batch_iter import BatchIter
from ..data.prep import build_sorted_slots, prep_batch, validate_fields
from ..data.remap import apply_remap, build_remap, count_sample
from ..ops.metrics import exact_auc
from ..parallel.store import make_store
from ..updaters.updater import FMUpdater
from ..utils import checkpoint
from ..utils.place import place_batch
from ..utils.prefetch import MappedPrefetchIter, ThreadedIter
from ..utils.progress import Progress, Reporter
from ..utils.tracing import profile_region
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


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


class SGDLearner:
    """``device`` defaults to the card and raises without one unless the
    caller asks for ``"cpu"`` (utils/device.py)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.updater = FMUpdater(cfg.effective_model_param())
        self.store = make_store(self.updater, cfg, device=device)
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
        with ``host_localize=0`` (the store localizes them)."""
        d = self.cfg.data
        # the cache key covers everything that changes batch content or
        # order; the raw count-pass stream is never cached (it runs once)
        cache_key = (f"{uri}|{shuffle}|{sorted_slots}"
                     if d.cache_batches and localize else None)
        if cache_key is not None and cache_key in self._batch_cache:
            placed, items = self._batch_cache[cache_key]
            return iter(items) if placed else self._place_iter(iter(items))
        if cache_key is not None:
            # the cache fixes one batch order for every epoch (the
            # reference's DataStore reuses the same compacted batches too)
            epoch = 0
        nppf = max(d.num_parts_per_file, 1)
        src = iter(BatchIter(
            uri,
            batch_size=d.batch_size,
            max_nnz=d.max_nnz_per_row,
            num_bits=d.num_bits,
            data_format=d.data_format,
            part_index=range(nppf),
            num_parts=nppf,
            shuffle=shuffle and d.shuffle,
            # epoch-dependent seed: each epoch must shuffle differently AND
            # a resumed run must reproduce the interrupted epoch's order
            seed=d.seed + epoch,
            batch_workers=d.batch_workers,
        ))
        if not localize:
            return ThreadedIter(src, depth=4)
        if self._host_localize:
            out = self._prep_iter(src, sorted_slots)
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

    def _check_raw(self, b):
        """A raw batch's libffm fields, range-checked on the host before
        placement (the store checks host arrays only)."""
        if self.cfg.expects_fields():
            validate_fields(b.fields, self.cfg.model.num_fields)
        return b

    def _prep_iter(self, src, sorted_slots: bool):
        """Prepped host batches of a raw batch stream, from a pool of prep
        workers."""
        d = self.cfg.data
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

        def prep(b):
            pb = prep_batch(b, num_rows, min_ub=min_ub, num_fields=nf,
                            remap=remap, hot_rows=hot)
            if sorted_slots:
                pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals,
                                                     with_slots=with_slots)
            return pb

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
        # the sorted slots only where the store's backward reads them
        with profile_region(f"train_epoch_{epoch}"):
            for batch in self._iter(cfg.data.data_in, shuffle=True,
                                    epoch=epoch,
                                    sorted_slots=self.store.sorted_grads):
                if step < skip:
                    step += 1
                    continue
                self.state, metrics = self._train_step(batch)
                acc = metrics if acc is None else merge_metrics(acc, metrics)
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
        if acc is not None:
            self._fold(prog, acc)
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

    def _save(self, meta: dict) -> str:
        """Checkpoint the state in canonical rows (a hot/cold state by the
        run's remap)."""
        return checkpoint.save(self.cfg.learner.model_out, self.state, meta,
                               remap_lut=self.store.hot_lut)

    def eval_pass(self, uri: str) -> Progress:
        prog = Progress()
        acc = None
        # (label, score) pairs are host-collected for the exact AUC up to
        # a cap; past it a uniform RESERVOIR sample of cap pairs replaces
        # the collection. The streaming binned AUC always covers the full
        # pass.
        cap = self.cfg.learner.exact_auc_cap
        res = _Reservoir(cap, self.cfg.data.seed) if cap > 0 else None
        for batch in self._iter(uri, shuffle=False):
            metrics, py = self._eval_step(batch)
            acc = metrics if acc is None else merge_metrics(acc, metrics)
            if res is not None:
                keep = _host(batch.mask) > 0
                res.add(_host(batch.labels)[keep], _host(py)[keep])
        if acc is not None:
            self._fold(prog, acc)
        if res is not None and res.n_seen:
            y, p = res.sample()
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
        m = StepMetrics(*(_host(t) for t in acc))
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

    # -- driver (reference: SGDLearner::RunScheduler) -----------------------

    def run(self) -> Progress:
        cfg = self.cfg
        if cfg.model.tail_feature_filter > 0 and not cfg.learner.model_in:
            self.count_pass()
        last = Progress()
        for epoch in range(self._epoch, cfg.learner.max_num_epochs):
            tr = self.train_epoch(epoch)
            log.info("epoch %d train: %s", epoch, tr.row())
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
                log.info("saved model to %s", path)
        return last

    def predict(self, uri: str) -> tuple[np.ndarray, np.ndarray]:
        """Batch prediction: returns (scores, labels) for all rows
        (reference: the validation/pred flow with model_in + no training)."""
        pys, ys = [], []
        for batch in self._iter(uri, shuffle=False):
            _, py = self._eval_step(batch)
            keep = _host(batch.mask) > 0
            pys.append(_host(py)[keep])
            ys.append(_host(batch.labels)[keep])
        if not pys:
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        return np.concatenate(pys), np.concatenate(ys)
