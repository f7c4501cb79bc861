"""Block coordinate descent learner for the sparse linear model.

Port of ``difacto_tpu/learners/bcd.py`` (reference:
``src/bcd/bcd_learner.h`` :: BCDLearner + ``bcd_updater.h`` (closed-form
proximal coordinate update) + ``src/loss/logit_loss_delta.h``
(cached-prediction delta loss) + ``src/data/tile_store.h``/
``tile_builder.h`` (column-block data layout)), on one device:

  * PrepareData: the dataset is streamed twice into a DISK tile cache
    (``data/tile_store.py``, the JAX package's files: per-feature-block
    COO tiles, split by row shard), so datasets larger than RAM train;
    tiles are read from disk and copied to the device one block ahead of
    the step, in a prefetch thread;
  * per epoch, blocks are visited in a random order; the block step
    scatter-adds the block gradient g_j = sum_i x_ij * d_i and curvature
    h_j = sum_i x_ij^2 * p_i(1-p_i) from the cached margins py, applies
    the closed-form l1/l2 proximal Newton coordinate update
    u = w_j h_j - g_j;  w_j' = sign(u) max(|u|-l1, 0) / (h_j + l2)
    and folds X_block @ (w' - w) into py — the logit_loss_delta trick,
    making an epoch O(nnz) in any block count;
  * per-epoch validation (data_val) scores the current w streaming and
    reports logloss + exact AUC, like the reference's validation jobs.

What differs from the JAX package: the block step is PyTorch tensor ops
(gathers and ``index_add_``) where the JAX step is XLA ops under
``shard_map``. The JAX step ``psum``s the per-shard sums over S row
shards; on one card the S shards of a block (``shard.num_shards``, 1 when
unset) are folded into one launch at rows ``s * rows_per_shard + tr[s]``,
whose sums are what ``psum`` computes, so a run at any S can be held
against the JAX package at the same S. On the card ``index_add_`` adds
with atomics, so the order of the sums (and an l1 threshold's last-bit
decision) can differ from run to run. Multi-process BCD (every process
tiling its own input parts, ``process_allgather`` of the shapes, the
per-process placement) waits for ROADMAP A9b and raises.

The linear model (V_dim must be 0) matches the reference: BCD exists
for exact-sparsity linear CTR models, FM training uses SGD.
"""

from __future__ import annotations

import logging
import tempfile

import numpy as np
import torch

from ..config import Config
from ..data.batch_iter import BatchIter
from ..data.tile_store import TileStore, build_tiles
from ..models.losses import stable_logloss
from ..ops.metrics import NUM_AUC_BINS, exact_auc
from ..parallel.multihost import refuse_multiprocess
from ..updaters.updater import FMState
from ..utils import checkpoint
from ..utils.device import resolve_device
from ..utils.prefetch import ThreadedIter
from ..utils.progress import Progress

log = logging.getLogger("difacto_tpu_torch")


def block_step(py, yy, mr, w_blk, rows, cols, vals, l1: float, l2: float):
    """One feature block's update, in place on ``py`` [n_pad] and
    ``w_blk`` (the block's [R] slice of w). ``rows``, ``cols``, ``vals``:
    the block's triplets, flat (the shards' local rows already offset into
    the shard-major py); padding triplets carry value 0 and add nothing.
    The arithmetic is the JAX step's, term for term."""
    p = py.index_select(0, rows)
    sig = torch.sigmoid(p)
    m = mr.index_select(0, rows)
    d = (sig - (yy.index_select(0, rows) > 0).to(sig.dtype)) * m
    h = sig * (1.0 - sig) * m
    R = w_blk.shape[0]
    g = torch.zeros(R, dtype=py.dtype, device=py.device).index_add_(
        0, cols, vals * d)
    hh = torch.zeros(R, dtype=py.dtype, device=py.device).index_add_(
        0, cols, vals * vals * h)
    u = w_blk * hh - g
    w_new = torch.sign(u) * torch.clamp(u.abs() - l1, min=0.0) / (hh + l2)
    w_new = torch.where(hh > 0, w_new, w_blk)  # untouched coords keep w
    dw = w_new - w_blk
    # py + (a scatter of the deltas into zeros), as the JAX step adds it
    py.add_(torch.zeros_like(py).index_add_(
        0, rows, vals * dw.index_select(0, cols)))
    w_blk.copy_(w_new)


def _check_one_process() -> None:
    """The port trains BCD in one process; a torch.distributed group of
    more than one rank is where the JAX package runs its multi-process
    branch."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1):
        raise NotImplementedError(
            "multi-process BCD (per-process tile stores and placement) is "
            "not in the PyTorch port yet (ROADMAP A9b)")


class BCDLearner:
    """``device`` defaults to the card and raises without one unless the
    caller asks for ``"cpu"`` (utils/device.py)."""

    def __init__(self, cfg: Config, device=None):
        refuse_multiprocess("BCDLearner")
        if cfg.model.V_dim != 0:
            raise ValueError("BCD trains the linear model (V_dim=0)")
        _check_one_process()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_rows = 1 << cfg.data.num_bits
        self.num_blocks = min(cfg.learner.bcd_num_blocks, self.num_rows)
        self.S = cfg.shard.num_shards or 1
        self.epoch_callbacks = []
        self._prepare_data()

    # -- PrepareData (reference: kPrepareData + TileBuilder) ----------------

    def _batch_iter(self, uri: str):
        d = self.cfg.data
        nppf = max(d.num_parts_per_file, 1)
        return BatchIter(
            uri,
            batch_size=d.batch_size,
            max_nnz=d.max_nnz_per_row,
            num_bits=d.num_bits,
            data_format=d.data_format,
            part_index=range(nppf),
            num_parts=nppf,
        )

    def _prepare_data(self) -> None:
        tile_dir = self.cfg.learner.bcd_tile_dir
        if not tile_dir:
            self._tmp = tempfile.TemporaryDirectory(prefix="difacto_tiles_")
            tile_dir = self._tmp.name
        self.tiles: TileStore = build_tiles(
            lambda: self._batch_iter(self.cfg.data.data_in),
            tile_dir,
            num_rows=self.num_rows,
            num_blocks=self.num_blocks,
            num_shards=self.S,
        )
        self.rows_per_block = self.tiles.rows_per_block
        self.labels = self.tiles.labels
        self.n = self.tiles.n
        self.shard_rows = self.tiles.rows_per_shard

    # -- state --------------------------------------------------------------

    def reset(self) -> None:
        """A fresh model: w = 0, py = 0, the labels and the row mask in
        shard-major order on the device, and the block order's generator."""
        dev, ts = self.device, self.tiles

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        # a NumPy generator on purpose: the block order must be the JAX
        # package's (difacto_tpu/learners/bcd.py:272) for w to be
        # comparable between the packages
        self._rng = np.random.default_rng(self.cfg.data.seed)
        self.w = torch.zeros(self.num_rows, dtype=torch.float32, device=dev)
        self.py = torch.zeros(self.S * self.shard_rows, dtype=torch.float32,
                              device=dev)
        self.yy = put(ts.to_shard_order(
            np.where(self.labels > 0, 1.0, -1.0).astype(np.float32),
            fill=-1.0))
        self.mr = put(ts.to_shard_order(np.ones(self.n, np.float32)))
        # shard s's local row r is py row s * rows_per_shard + r
        self._shard_base = (torch.arange(self.S, dtype=torch.int32,
                                         device=dev)[:, None]
                            * self.shard_rows)

    def block_tensors(self, block: int):
        """One block's tiles on the device, flat: (rows, cols, vals),
        padded to the block's own largest shard extent (the JAX step pads
        every block to the store's largest, one static shape for XLA)."""
        tr, tc, tv = self.tiles.fetch(block, self.tiles.block_nnz(block))
        dev = self.device
        tr = torch.from_numpy(tr).to(dev)
        rows = (tr + self._shard_base).reshape(-1)
        return (rows, torch.from_numpy(tc).to(dev).reshape(-1),
                torch.from_numpy(tv).to(dev).reshape(-1))

    def step(self, block: int, rows, cols, vals) -> None:
        """The block step on the learner's state (w's block slice in
        place)."""
        R = self.rows_per_block
        p = self.cfg.model
        block_step(self.py, self.yy, self.mr,
                   self.w[block * R:(block + 1) * R], rows, cols, vals,
                   p.l1, p.l2)

    def _tile_stream(self, order):
        """Tiles read from the disk cache and copied to the device one
        block ahead (reference: TileStore::Prefetch overlapping fetch with
        compute)."""
        return ThreadedIter(
            ((int(b),) + self.block_tensors(int(b)) for b in order), depth=2)

    # -- validation (reference: the data_val jobs — pull+predict, no push) --

    def eval_pass(self, uri: str) -> Progress:
        """Scores with a gather of w on the device; the metrics and the
        binned histogram on the host, as the JAX package builds them."""
        pys, ys = [], []
        for batch in self._batch_iter(uri):
            ids = torch.from_numpy(batch.ids).to(self.device)
            vals = torch.from_numpy(batch.vals).to(self.device)
            valid = ids >= 0
            wi = self.w.index_select(
                0, torch.where(valid, ids, 0).reshape(-1)).reshape(ids.shape)
            py = (vals * wi * valid).sum(dim=1).cpu().numpy()
            keep = batch.mask > 0
            pys.append(py[keep])
            ys.append(batch.labels[keep])
        y = np.concatenate(ys) if ys else np.zeros(0, np.float32)
        py = np.concatenate(pys) if pys else np.zeros(0, np.float32)
        yy = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        loss = np.logaddexp(0.0, -yy * py)
        prob = 1.0 / (1.0 + np.exp(-np.clip(py, -30.0, 30.0)))
        bins = np.clip((prob * NUM_AUC_BINS).astype(np.int64), 0,
                       NUM_AUC_BINS - 1)
        hist = np.zeros((2, NUM_AUC_BINS), np.float64)
        np.add.at(hist, ((y > 0).astype(np.int64), bins), 1.0)
        prog = Progress(
            num_examples=float(len(y)),
            logloss_sum=float(loss.sum()),
            correct_sum=float(((py > 0) == (y > 0)).sum()),
            label_sum=float(y.sum()),
            pred_sum=float(prob.sum()),
            auc_hist=hist,
        )
        prog.exact_auc = exact_auc(y, py)
        return prog

    # -- the run (reference: BCDLearner::RunScheduler) ----------------------

    def sweep(self) -> None:
        """Every block once, in the generator's next order."""
        for b, rows, cols, vals in self._tile_stream(
                self._rng.permutation(self.num_blocks)):
            self.step(b, rows, cols, vals)

    def train_epoch(self, epoch: int) -> Progress:
        """A sweep, then the train metrics over the cached margins."""
        self.sweep()
        loss = stable_logloss(-self.yy * self.py) * self.mr
        correct = ((self.py > 0) == (self.yy > 0)).to(torch.float32) * self.mr
        prog = Progress(
            num_examples=float(self.n),
            logloss_sum=float(loss.sum()),
            correct_sum=float(correct.sum()),
        )
        prog.nnz_w = float((self.w != 0).sum())
        prog.exact_auc = exact_auc(
            self.labels, self.tiles.from_shard_order(self.py.cpu().numpy()))
        log.info(
            "bcd epoch %d train: logloss %.6f auc %.6f acc %.4f |w|>0 %d",
            epoch, prog.logloss, prog.exact_auc, prog.accuracy,
            int(prog.nnz_w),
        )
        return prog

    def run(self) -> Progress:
        cfg = self.cfg
        self.reset()
        last = Progress()
        for epoch in range(cfg.learner.max_num_epochs):
            prog = self.train_epoch(epoch)
            if cfg.data.data_val:
                va = self.eval_pass(cfg.data.data_val)
                log.info(
                    "bcd epoch %d valid: %s exact_auc %.6f",
                    epoch, va.row(), va.exact_auc,
                )
                va.nnz_w = prog.nnz_w
                prog = va
            for cb in self.epoch_callbacks:
                cb(epoch, prog)
            last = prog
        if cfg.learner.model_out:
            # the linear model as an FMState (zero z, n and cnt, no
            # factors): it scores through the SGD eval path of either
            # package
            w = self.w
            empty = torch.zeros((0, self.num_rows), dtype=w.dtype,
                                device=w.device)
            state = FMState(w=w, z=torch.zeros_like(w), n=torch.zeros_like(w),
                            V=empty, nV=empty, cnt=torch.zeros_like(w))
            checkpoint.save(cfg.learner.model_out, state, {"learner": "bcd"})
        return last
