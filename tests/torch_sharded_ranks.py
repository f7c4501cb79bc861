"""The port's ShardedStore cases, run on the ranks of a gloo group.

Imported by tests/test_torch_sharded.py, which holds each case's result
against the JAX ShardedStore on an S-device CPU mesh, and run by
``difacto_tpu_torch.parallel.launch`` in S processes (``run``). It
imports nothing of JAX: a rank process loads torch and the port only.

A case is a config on top of :data:`BASE`, a seeded batch stream and a
seeded start state (NumPy, over the hash space, so that both packages
start from the same table), a count pass where it asks for one, the train
steps (host-prepped, or device-localized with ``raw``), with
``pin_capacity`` and a second pass where it asks for them, and an eval
step. Its result (rank 0 writes it) is the gathered table's planar leaves,
each step's summed metrics, the eval scores and the store's stats.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

BATCH, BITS, NNZ = 192, 12, 16  # S = 1, 2 and 3 divide the batch
BASE = dict(batch_size=BATCH, num_bits=BITS, max_nnz_per_row=NNZ, V_dim=4,
            store="sharded", V_threshold=2, l1=0.1, lr_eta=0.1)
BUCKETS = (1024, 2048)  # small unique buckets (the default starts at 2^14)

# name -> config keys beyond BASE, and the run's options: zipf (the batch
# stream of the flagship's Zipf(1.2) ids), count (a count pass first), raw
# (device-localized steps), pin (pin_capacity after the first pass, then a
# second pass), fields (explicit libffm fields, shuffled within each row)
CASES = {
    "pairs_packed": dict(kernel="pairs", layout="packed", pin=True),
    "pairs_planar_scatter": dict(kernel="pairs", layout="planar",
                                 segsum="scatter"),
    "pairs_zipf_tail": dict(kernel="pairs", zipf=True, count=True,
                            tail_feature_filter=2, V_threshold=3,
                            w_updater="adagrad", V_updater="sgd"),
    "pairs_logit": dict(kernel="pairs", V_dim=0),
    "pallas_packed": dict(kernel="pallas", layout="packed"),
    "pallas_planar_sorted": dict(kernel="pallas", layout="planar",
                                 segsum="sorted", count=True),
    "xla_stacked": dict(kernel="xla", segsum="sorted"),
    "xla_planar_overflow": dict(kernel="xla", layout="planar",
                                segsum="scatter", capacity_factor=0.25),
    "xla_raw_overflow": dict(kernel="xla", raw=True, capacity_factor=0.25,
                             host_localize=0),
    "ffm_pairs": dict(kernel="pairs", loss="ffm", V_dim=1),
    "ffm_pallas": dict(kernel="pallas", loss="ffm", V_dim=1),
    "ffm_fields_pairs": dict(kernel="pairs", loss="ffm", V_dim=1,
                             data_format="libffm", num_fields=12,
                             fields=True),
}
RUN_KEYS = ("zipf", "count", "raw", "pin", "fields")
# the cases each group runs: S = 2 all of them, S = 3 (a padded table)
# one of each table path
GROUPS = {2: tuple(CASES), 3: ("pairs_packed", "pallas_packed",
                              "xla_stacked", "ffm_pairs")}


def config_keys(name: str, S: int) -> list[tuple[str, str]]:
    kw = {**BASE, **{k: v for k, v in CASES[name].items()
                     if k not in RUN_KEYS}, "num_shards": S}
    return [(k, str(v)) for k, v in kw.items()]


def case_batches(name: str):
    """The case's global batches (the port's generator and batcher give
    the JAX package's arrays)."""
    from difacto_tpu_torch.data.batch_iter import rowblock_to_batches
    from difacto_tpu_torch.data.synthetic import make_ctr_data
    from difacto_tpu_torch.probes.common import flagship_batch

    if CASES[name].get("zipf"):
        return [flagship_batch(40 + i, BATCH, NNZ, BITS) for i in range(4)]
    fields = bool(CASES[name].get("fields"))
    blk = make_ctr_data(4 * BATCH, num_fields=12, vocab_per_field=400,
                        seed=sum(map(ord, name)), with_fields=fields,
                        shuffle_slots=fields)
    return list(rowblock_to_batches(blk, BATCH, NNZ, BITS))


def start_state(k: int, seed: int = 7) -> dict[str, np.ndarray]:
    """A trained-looking table over the hash space: nonzero optimizer
    leaves, counts on both sides of the thresholds."""
    rng = np.random.default_rng(seed)
    n = 1 << BITS
    return {"w": rng.normal(size=n).astype(np.float32) * 0.1,
            "z": rng.normal(size=n).astype(np.float32),
            "n": rng.random(n).astype(np.float32),
            "cnt": rng.integers(0, 4, n).astype(np.float32),
            "V": rng.uniform(-0.01, 0.01, (k, n)).astype(np.float32),
            "nV": rng.random((k, n)).astype(np.float32)}


def run_case(name: str, device: str = "cpu") -> dict[str, np.ndarray]:
    """The port's run of case ``name`` on this process's group (S = 1
    without one)."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.prep import (build_sorted_slots_sharded,
                                             prep_batch_sharded)
    from difacto_tpu_torch.parallel.comm import Comm
    from difacto_tpu_torch.parallel.store import ShardedStore
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.checkpoint import state_from_numpy

    opts = CASES[name]
    S = Comm().size
    cfg = Config.from_kwargs(config_keys(name, S))
    store = ShardedStore(FMUpdater(cfg.effective_model_param()), cfg,
                         device=device)
    state = store.place_state(state_from_numpy(
        start_state(store.param.V_dim)))
    batches = case_batches(name)
    if opts.get("count"):
        for b in batches:
            state = store.count_step(state, b.ids)
    metrics = []

    def train_pass():
        nonlocal state
        for b in batches:
            if opts.get("raw"):
                state, m = store.train_step(state, b.ids, b.vals, b.labels,
                                            b.mask)
            else:
                pb = prep_batch_sharded(b, store.num_rows, S,
                                        buckets=BUCKETS)
                if store.sorted_grads:
                    pb.sorted_slots = build_sorted_slots_sharded(
                        pb, with_slots=cfg.learner.loss == "ffm")
                state, m = store.train_step_prepped(state, pb)
            metrics.append([float(m.examples), float(m.logloss_sum),
                            float(m.dropped_ids)])

    train_pass()
    pin = 0
    if opts.get("pin"):
        pin = store.pin_capacity()
        train_pass()
    b = batches[0]
    if opts.get("raw"):
        m, py = store.eval_step(state, b.ids, b.vals, b.labels, b.mask)
    else:
        m, py = store.eval_step_prepped(
            state, prep_batch_sharded(b, store.num_rows, S, buckets=BUCKETS))
    host = store.gather_state(state)
    stats = store.stats(state)
    return {**{k: getattr(host, k).numpy() for k in
               ("w", "z", "n", "cnt", "V", "nV")},
            "metrics": np.asarray(metrics, np.float64),
            "eval": np.asarray([float(m.examples), float(m.logloss_sum),
                                float(m.dropped_ids)]),
            "py": py.detach().cpu().numpy(),
            "stats": np.asarray([stats["nnz_w"], stats["nnz_V"]]),
            "pin": np.asarray(pin), "num_rows": np.asarray(store.num_rows)}


def run(out_dir: str, S: str) -> None:
    """Every case of group S on this rank; rank 0 writes the results."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    for name in GROUPS[int(S)]:
        res = run_case(name)
        if dist.get_rank() == 0:
            np.savez(Path(out_dir) / f"{name}.npz", **res)


if __name__ == "__main__":
    print(run_case(sys.argv[1]))
