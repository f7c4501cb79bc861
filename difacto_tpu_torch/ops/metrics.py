"""Binary classification metrics.

Port of ``difacto_tpu/ops/metrics.py`` (reference:
``src/loss/bin_class_metric.h`` :: BinClassMetric). Two AUC paths:

* :func:`exact_auc` — host-side sort-based AUC (the north-star metric);
* binned histograms (:func:`auc_hist_update` on the device,
  :func:`auc_from_hist` on the host) — additive across steps, the
  streaming form that feeds ``Progress``.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_AUC_BINS = 1024


def exact_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Sort-based AUC with proper tie handling (average rank), matching the
    reference BinClassMetric::AUC semantics. labels in {0,1} (or {-1,+1})."""
    y = np.asarray(labels).astype(np.float64)
    y = (y > 0).astype(np.float64)
    s = np.asarray(scores).astype(np.float64)
    n_pos = y.sum()
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(s, kind="mergesort")
    s_sorted = s[order]
    # vectorized tie-averaged ranks
    _, inv, counts = np.unique(s_sorted, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    start = cum - counts
    avg = (start + cum + 1) / 2.0  # average of ranks [start+1 .. cum]
    ranks = avg[inv]
    rank_pos = ranks[y[order] > 0].sum()
    return float((rank_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def logloss(labels: np.ndarray, py: np.ndarray) -> float:
    """Mean log(1 + exp(-y*py)) with y in {-1,+1} (labels may be {0,1})."""
    y = np.where(np.asarray(labels) > 0, 1.0, -1.0)
    m = -y * np.asarray(py, dtype=np.float64)
    return float(np.mean(np.log1p(np.exp(-np.abs(m))) + np.maximum(m, 0.0)))


def auc_hist_update(hist: torch.Tensor, py: torch.Tensor,
                    labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Accumulate per-class score histograms on the device.

    hist: f32[2, NUM_AUC_BINS] (row 0 = negatives, row 1 = positives);
    py: raw margins; labels in {0,1}; weights: 1 for real rows, 0 for
    padding. Returns a new histogram."""
    p = torch.clamp(py, -30.0, 30.0)
    prob = 1.0 / (1.0 + torch.exp(-p))
    bins = torch.clamp((prob * NUM_AUC_BINS).to(torch.int64), 0, NUM_AUC_BINS - 1)
    is_pos = (labels > 0).to(torch.int64)
    flat_idx = is_pos * NUM_AUC_BINS + bins
    upd = torch.zeros(2 * NUM_AUC_BINS, dtype=hist.dtype, device=hist.device)
    upd.index_add_(0, flat_idx, weights.to(hist.dtype))
    return hist + upd.reshape(2, NUM_AUC_BINS)


def auc_hist_error_bound(hist: np.ndarray) -> float:
    """Worst-case |binned - exact| AUC error for this histogram: only
    (pos, neg) pairs in the SAME bin can differ (scored 0.5 as ties), so
    the error is at most 0.5 * sum_b pos_b*neg_b / (P*N)."""
    h = np.asarray(hist, dtype=np.float64)
    neg, pos = h[0], h[1]
    n_neg, n_pos = neg.sum(), pos.sum()
    if n_neg == 0 or n_pos == 0:
        return 0.0
    return float(0.5 * np.dot(pos, neg) / (n_pos * n_neg))


def auc_from_hist(hist: np.ndarray) -> float:
    """AUC from (neg, pos) score histograms with within-bin tie averaging."""
    h = np.asarray(hist, dtype=np.float64)
    neg, pos = h[0], h[1]
    n_neg, n_pos = neg.sum(), pos.sum()
    if n_neg == 0 or n_pos == 0:
        return 0.5
    cum_neg = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    wins = float(np.dot(pos, cum_neg))
    ties = float(np.dot(pos, neg)) * 0.5
    return (wins + ties) / (n_pos * n_neg)
