"""CLI entry point.

Port of ``difacto_tpu/cli.py`` (reference: ``src/difacto.cc`` :: main) —
a config file of ``key = val`` lines plus CLI ``key=val`` overrides,
dispatched to a learner (``learner=sgd|bcd``), on the card:

    python -m difacto_tpu_torch [config.conf] [key=val ...]

``task=predict`` scores ``data_in`` with the checkpoint ``model_in``
through the SGD eval path, whatever learner trained it, on any table
path: with ``hot_rows`` the learner builds its remap from ``data_in`` and
places the canonical checkpoint through it; with ``host_localize=0`` the
batches are localized on the device. ``pred_out`` may be a remote URI
(data/io.py).

Several processes: the launcher starts one a rank with the JAX package's
env contract (parallel/multihost.py), e.g. on one host

    DIFACTO_COORDINATOR=localhost:<port> DIFACTO_NUM_PROCESSES=2 \
    DIFACTO_PROCESS_ID=<p> python -m difacto_tpu_torch <conf>

``main`` joins the group first; the learner then trains one sharded model
over the processes' input parts (learners/sgd.py). ``task=predict``
writes ``pred_out.part{p}``, each process's rows in its parts' order, and
every process logs the logloss and AUC of the whole prediction set.
"""

from __future__ import annotations

import logging
import sys

from .config import Config
from .utils import arg_parser

log = logging.getLogger("difacto_tpu_torch")


def main(argv: list[str] | None = None, device=None) -> int:
    """``device`` defaults to the card and raises without one unless the
    caller asks for ``"cpu"``."""
    from .base import tune_malloc

    tune_malloc()  # large ingest temporaries must not page-fault
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
        datefmt="%H:%M:%S",
    )
    if argv is None:
        argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print(Config())
        return 0
    from .parallel.multihost import leave, maybe_initialize_distributed

    maybe_initialize_distributed()
    cfg = Config.from_kwargs(arg_parser.parse(argv))
    if not cfg.data.data_in:
        raise SystemExit("data_in is required")
    if cfg.learner.task == "predict":
        rc = run_predict(cfg, device)
    else:
        create_learner(cfg, device).run()
        rc = 0
    leave()
    return rc


def create_learner(cfg: Config, device=None):
    """Learner::Create (reference: src/learner.cc factory)."""
    if cfg.learner.learner == "sgd":
        from .learners.sgd import SGDLearner

        return SGDLearner(cfg, device=device)
    if cfg.learner.learner == "bcd":
        from .learners.bcd import BCDLearner

        return BCDLearner(cfg, device=device)
    raise ValueError(f"unknown learner {cfg.learner.learner!r}")


def run_predict(cfg: Config, device=None) -> int:
    """Batch prediction (reference: the model_in + pred_out flow — same
    binary, no training jobs). Scores are raw margins py; apply a sigmoid
    for probabilities."""
    import numpy as np

    from .data.io import open_uri
    from .learners.sgd import SGDLearner
    from .ops.metrics import exact_auc, logloss
    from .parallel.comm import allgather_pairs
    from .parallel.multihost import process_count, process_index

    if not cfg.learner.model_in:
        raise SystemExit("task=predict requires model_in")
    # scoring always uses the SGD eval path: checkpoints are a shared
    # format, so BCD-trained linear models score through it too
    cfg.learner.max_num_epochs = 0
    cfg.learner.learner = "sgd"
    learner = SGDLearner(cfg, device=device)
    py, labels = learner.predict(cfg.data.data_in)
    out = cfg.learner.pred_out
    if out:
        # several processes: each writes its own part file (reference:
        # every worker's pred job writes pred_out + its rank)
        if process_count() > 1:
            out = f"{out}.part{process_index()}"
        with open_uri(out, "wb") as f:
            np.savetxt(f, py, fmt="%.6g")
        log.info("wrote %d scores to %s", len(py), out)
    # the metrics of the whole prediction set, the same on every process
    labels, py = allgather_pairs(labels, py)
    if len(set(np.asarray(labels) > 0)) > 1:
        log.info(
            "predict: #ex %d  logloss %.6f  auc %.6f",
            len(py), logloss(labels, py), exact_auc(labels, py),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
