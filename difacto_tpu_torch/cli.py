"""CLI entry point.

Port of ``difacto_tpu/cli.py`` (reference: ``src/difacto.cc`` :: main) —
a config file of ``key = val`` lines plus CLI ``key=val`` overrides,
dispatched to the SGD learner, on the card:

    python -m difacto_tpu_torch [config.conf] [key=val ...]

``task=predict`` scores ``data_in`` with the checkpoint ``model_in``, on
any table path: with ``hot_rows`` the learner builds its remap from
``data_in`` and places the canonical checkpoint through it; with
``host_localize=0`` the batches are localized on the device.
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
    cfg = Config.from_kwargs(arg_parser.parse(argv))
    if not cfg.data.data_in:
        raise SystemExit("data_in is required")
    from .learners.sgd import SGDLearner

    if cfg.learner.task == "predict":
        return run_predict(cfg, device)
    SGDLearner(cfg, device=device).run()
    return 0


def run_predict(cfg: Config, device=None) -> int:
    """Batch prediction (reference: the model_in + pred_out flow — same
    binary, no training jobs). Scores are raw margins py; apply a sigmoid
    for probabilities."""
    import numpy as np

    from .learners.sgd import SGDLearner
    from .ops.metrics import exact_auc, logloss

    if not cfg.learner.model_in:
        raise SystemExit("task=predict requires model_in")
    cfg.learner.max_num_epochs = 0
    learner = SGDLearner(cfg, device=device)
    py, labels = learner.predict(cfg.data.data_in)
    if cfg.learner.pred_out:
        np.savetxt(cfg.learner.pred_out, py, fmt="%.6g")
        log.info("wrote %d scores to %s", len(py), cfg.learner.pred_out)
    if len(set(np.asarray(labels) > 0)) > 1:
        log.info(
            "predict: #ex %d  logloss %.6f  auc %.6f",
            len(py), logloss(labels, py), exact_auc(labels, py),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
