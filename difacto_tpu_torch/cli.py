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
(data/io.py). One process: under the JAX package's multi-process env
contract (``DIFACTO_COORDINATOR`` and ``DIFACTO_NUM_PROCESSES`` > 1) it
raises NotImplementedError naming ROADMAP A9b before it reads anything.
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
    from .parallel.multihost import refuse_multiprocess

    refuse_multiprocess("cli.main")
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
    cfg = Config.from_kwargs(arg_parser.parse(argv))
    if not cfg.data.data_in:
        raise SystemExit("data_in is required")
    if cfg.learner.task == "predict":
        return run_predict(cfg, device)
    create_learner(cfg, device).run()
    return 0


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
        with open_uri(out, "wb") as f:
            np.savetxt(f, py, fmt="%.6g")
        log.info("wrote %d scores to %s", len(py), out)
    if len(set(np.asarray(labels) > 0)) > 1:
        log.info(
            "predict: #ex %d  logloss %.6f  auc %.6f",
            len(py), logloss(labels, py), exact_auc(labels, py),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
