"""A process of a multi-process launch, at the store's level.

Run by tests/test_torch_multiprocess.py under the env contract
(``difacto_tpu_torch.parallel.launch.run_processes``, P = 2 and 3 on the
CPU): it joins the group as the CLI does, then checks what the launch
makes of ``store=auto``, ``store=local`` and ``hot_rows``, preps its own rows (each
process a different number of distinct ids) and asks the store for the
pairs capacity, which the processes agree by a host allgather, and loads
a JAX-format per-process checkpoint onto its shard. It writes
``rank{p}.npz`` for the test to compare. :func:`learner_global` is a rank
of a ``run_ranks`` group instead. It imports nothing of JAX.
"""

from __future__ import annotations

import os

import numpy as np

from difacto_tpu_torch.parallel.store import _cap_ladder as ladder  # noqa: F401

# the store of the rank program: 2 and 3 divide the batch
STORE_KEYS = [("batch_size", "192"), ("num_bits", "12"),
              ("max_nnz_per_row", "16"), ("V_dim", "4")]


def jax_set_leaves() -> dict[str, np.ndarray]:
    """The planar leaves of the JAX-format file set (2^12 rows, K = 4),
    from a seed."""
    rng = np.random.default_rng(77)
    n, k = 1 << 12, 4
    return {"w": rng.normal(size=n).astype(np.float32),
            "z": rng.normal(size=n).astype(np.float32),
            "n": rng.random(n).astype(np.float32),
            "V": rng.normal(size=(k, n)).astype(np.float32),
            "nV": rng.random((k, n)).astype(np.float32),
            "cnt": rng.integers(0, 9, n).astype(np.float32)}


def run(out_dir: str, jax_set: str) -> None:
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.batch_iter import Batch
    from difacto_tpu_torch.data.prep import prep_batch_sharded
    from difacto_tpu_torch.parallel.multihost import (
        leave, maybe_initialize_distributed)
    from difacto_tpu_torch.parallel.store import ShardedStore, make_store
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils import checkpoint

    pid, P = maybe_initialize_distributed()
    cfg = Config.from_kwargs(STORE_KEYS)
    store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
    assert isinstance(store, ShardedStore)
    try:
        make_store(FMUpdater(cfg.model), Config.from_kwargs(
            STORE_KEYS + [("store", "local")]), device="cpu")
        local_error = ""
    except ValueError as e:
        local_error = str(e)
    # the hot/cold split is a one-table feature: a multi-process launch
    # (sharded) refuses it when the store is made, before any save
    try:
        make_store(FMUpdater(cfg.model), Config.from_kwargs(
            STORE_KEYS + [("hot_rows", "-1")]), device="cpu")
        hot_error = ""
    except ValueError as e:
        hot_error = str(e)
    # this process's rows: 96 rows of 16 ids from a range that grows with
    # the rank, so that each rank's largest bucket fill differs
    rng = np.random.default_rng(500 + pid)
    rows = cfg.data.batch_size // P
    ids = rng.integers(0, 600 + 900 * pid, (rows, 16)).astype(np.int32)
    b = Batch(ids, np.ones((rows, 16), np.float32),
              np.ones(rows, np.float32), np.ones(rows, np.float32))
    pb = prep_batch_sharded(b, store.num_rows, 1, fixed_ub=store.unique_size,
                            num_shards_global=P)
    capacity = store.pairs_capacity(pb)
    pin = store.pin_capacity()
    state, _ = checkpoint.load_for_store(jax_set, store)
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), S=store.S,
             local_rows=store.local_rows, local_error=local_error,
             hot_error=hot_error,
             local_fill=pb.max_fill, capacity=capacity, pin=pin, lo=store.lo,
             rows=store.rows_per_shard,
             **checkpoint.state_to_numpy(state))
    leave()


def learner_global(conf: str, model_out: str) -> None:
    """A rank of a ``run_ranks`` group (no launch contract) training the
    conf through SGDLearner: every rank reads the whole data and steps its
    row group of each global batch; rank 0 writes the gathered table."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.parallel.store import ShardedStore
    from difacto_tpu_torch.utils import arg_parser

    cfg = Config.from_kwargs(arg_parser.parse([conf, "store=sharded",
                                               f"model_out={model_out}"]))
    learner = SGDLearner(cfg, device="cpu")
    assert isinstance(learner.store, ShardedStore)
    assert learner.store.S == 2 and not learner.store.local_rows
    learner.run()
