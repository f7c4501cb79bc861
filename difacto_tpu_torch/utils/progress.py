"""Additive training progress + reporting.

Counterpart of the reference's ``include/difacto/progress.h`` :: Progress
(an additive vector of metric sums merged across nodes) and
``include/difacto/reporter.h`` :: Reporter (worker -> scheduler progress
channel). Under synchronous SPMD there is no scheduler process; Progress
is an additive dataclass summed across steps/hosts, and Reporter becomes a
periodic logging callback on the driver.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger("difacto_tpu_torch")


@dataclass
class Progress:
    """Additive metric sums; merge == field-wise add (reference: Progress::Merge)."""

    num_examples: float = 0.0
    logloss_sum: float = 0.0      # sum over examples of log(1 + exp(-y*py))
    correct_sum: float = 0.0      # examples with sign-correct prediction
    label_sum: float = 0.0        # clicks
    pred_sum: float = 0.0         # predicted clicks (sum of sigmoid(py))
    auc_hist: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 1024), dtype=np.float64)
    )                              # binned (neg, pos) score histograms for AUC
    nnz_w: float = 0.0            # latest snapshot (not additive)
    nnz_V: float = 0.0
    exact_auc: float | None = None  # host sort-based AUC when collected
    exact_auc_truncated: bool = False  # exact_auc is reservoir-sampled
    exact_auc_n: int = 0          # pairs the exact AUC was computed over
    exact_auc_of: int = 0         # total pairs seen in the pass

    def merge(self, other: "Progress") -> "Progress":
        self.num_examples += other.num_examples
        self.logloss_sum += other.logloss_sum
        self.correct_sum += other.correct_sum
        self.label_sum += other.label_sum
        self.pred_sum += other.pred_sum
        self.auc_hist = self.auc_hist + other.auc_hist
        self.nnz_w = other.nnz_w or self.nnz_w
        self.nnz_V = other.nnz_V or self.nnz_V
        return self

    @property
    def logloss(self) -> float:
        return self.logloss_sum / max(self.num_examples, 1.0)

    @property
    def accuracy(self) -> float:
        return self.correct_sum / max(self.num_examples, 1.0)

    @property
    def copc(self) -> float:
        """Clicks over predicted clicks — 1.0 means calibrated
        (reference: the COPC column of BinClassMetric)."""
        return self.label_sum / max(self.pred_sum, 1e-12)

    @property
    def auc(self) -> float:
        from ..ops.metrics import auc_from_hist

        return auc_from_hist(self.auc_hist)

    @property
    def auc_error_bound(self) -> float:
        """Worst-case |auc - exact AUC| from the histogram itself (see
        ops.metrics.auc_hist_error_bound)."""
        from ..ops.metrics import auc_hist_error_bound

        return auc_hist_error_bound(self.auc_hist)

    def row(self) -> str:
        return (
            f"#ex {int(self.num_examples):>12d}  logloss {self.logloss:.6f}  "
            f"auc {self.auc:.6f}  acc {self.accuracy:.4f}  "
            f"copc {self.copc:.4f}  "
            f"|w|>0 {int(self.nnz_w)}  |V|act {int(self.nnz_V)}"
        )


class Reporter:
    """Periodic progress printer (reference: Reporter + the scheduler's
    epoch table printed in SGDLearner::RunScheduler)."""

    def __init__(self, interval_steps: int = 100):
        self.interval = interval_steps
        self.reset()

    def reset(self) -> None:
        """Call at epoch start: rate deltas must not span epochs."""
        self._t0 = time.time()
        self._last_examples = 0.0
        self._last_t = self._t0

    def maybe_report(self, step: int, progress: Progress, prefix: str = "") -> None:
        if self.interval <= 0 or step % self.interval != 0:
            return
        now = time.time()
        dt = max(now - self._last_t, 1e-9)
        eps = (progress.num_examples - self._last_examples) / dt
        self._last_t, self._last_examples = now, progress.num_examples
        log.info("%sstep %d  %s  (%.0f ex/s)", prefix, step, progress.row(), eps)
