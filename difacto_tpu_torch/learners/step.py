"""Worker-side batch math of the train and eval steps.

Port of the fm/logit half of ``difacto_tpu/learners/step.py`` (reference:
the body of ``src/sgd/sgd_learner.h`` :: SGDLearner::Process — pull ->
Loss::Predict/CalcGrad -> per-key gradient aggregation -> push). The
store (parallel/store.py) decides where the table rows come from and
where the gradients go; the math here is the same for both.

Two per-key aggregations:

* :func:`worker_grads` — the scatter path (``segsum=scatter``, and
  ``kernel=pallas``'s default), with ``index_add_``;
* :func:`worker_grads_sorted` — the sorted path (``segsum=sorted``, and
  ``kernel=pairs``'s default): the backward runs in host-sorted slot
  order and the per-key sums come from the segment-sum kernel
  (ops/segsum.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.losses import fm_loss_grad, fm_predict, logit_grad_coeff
from ..ops.localize import Localized
from ..ops.metrics import NUM_AUC_BINS, auc_hist_update
from ..ops.segsum import segsum_sorted


class StepMetrics(NamedTuple):
    """Additive per-step metrics, as device tensors (feeds
    utils.progress.Progress when the learner folds them)."""

    examples: torch.Tensor      # f32 [] number of real rows
    logloss_sum: torch.Tensor   # f32 []
    correct_sum: torch.Tensor   # f32 []
    label_sum: torch.Tensor     # f32 [] sum of labels (clicks)
    pred_sum: torch.Tensor      # f32 [] sum of sigmoid(py) (predicted clicks)
    auc_hist: torch.Tensor      # f32 [2, NUM_AUC_BINS]
    dropped_ids: torch.Tensor   # f32 [] routing-capacity overflow (sharded only)


def zero_metrics(device) -> StepMetrics:
    def z():
        return torch.zeros((), dtype=torch.float32, device=device)

    return StepMetrics(z(), z(), z(), z(), z(),
                       torch.zeros((2, NUM_AUC_BINS), dtype=torch.float32,
                                   device=device), z())


def merge_metrics(a: StepMetrics, b: StepMetrics) -> StepMetrics:
    return StepMetrics(*(x + y for x, y in zip(a, b)))


def _batch_metrics(py, loss, correct, labels, mask) -> StepMetrics:
    zero = torch.zeros((), dtype=torch.float32, device=py.device)
    return StepMetrics(
        examples=mask.sum(),
        logloss_sum=loss.sum(),
        correct_sum=correct.sum(),
        label_sum=(labels * mask).sum(),
        pred_sum=(torch.sigmoid(py) * mask).sum(),
        auc_hist=auc_hist_update(
            torch.zeros((2, NUM_AUC_BINS), dtype=torch.float32,
                        device=py.device),
            py, labels, mask,
        ),
        dropped_ids=zero,
    )


def worker_forward(
    rows_u: torch.Tensor,  # f32 [U, 1+K] pulled unique rows (w | V)
    loc: Localized,
    vals: torch.Tensor,    # f32 [B, L]
    labels: torch.Tensor,  # f32 [B] in {0,1}
    mask: torch.Tensor,    # f32 [B]
) -> tuple[torch.Tensor, StepMetrics]:
    """The eval step's math: forward only. Returns (py [B], metrics)."""
    B, L = vals.shape
    D = rows_u.shape[1]
    rows = rows_u.index_select(0, loc.inv).reshape(B, L, D)
    fwd = fm_predict(vals, rows[..., 0], rows[..., 1:])
    _, loss, correct = logit_grad_coeff(fwd.py, labels, mask)
    return fwd.py, _batch_metrics(fwd.py, loss, correct, labels, mask)


def worker_grads(
    rows_u: torch.Tensor,  # f32 [U, 1+K] pulled unique rows (w | V)
    loc: Localized,
    vals: torch.Tensor,    # f32 [B, L]
    labels: torch.Tensor,  # f32 [B] in {0,1}
    mask: torch.Tensor,    # f32 [B]
) -> tuple[torch.Tensor, torch.Tensor, StepMetrics]:
    """Per-unique-id aggregated gradients by scatter-add. Returns
    (grads_u [U, 1+K], py [B], metrics)."""
    B, L = vals.shape
    U, D = rows_u.shape
    K = D - 1
    rows = rows_u.index_select(0, loc.inv).reshape(B, L, D)
    fwd, g = fm_loss_grad(vals, rows[..., 0], rows[..., 1:], labels, mask)
    flat = torch.cat([g.dW.reshape(B * L, 1), g.dV.reshape(B * L, K)], dim=1)
    grads_u = torch.zeros((U, D), dtype=flat.dtype, device=flat.device)
    grads_u.index_add_(0, loc.inv, flat)
    return grads_u, fwd.py, _batch_metrics(fwd.py, g.loss, g.correct,
                                           labels, mask)


def worker_grads_sorted(
    rows_u: torch.Tensor,  # f32 [U, 1+K] pulled unique rows (w | V)
    loc: Localized,
    vals: torch.Tensor,    # f32 [B, L]
    labels: torch.Tensor,  # f32 [B]
    mask: torch.Tensor,    # f32 [B]
    ss: tuple,             # (x_sorted [BLp], bidx [BLp], inv_sorted [BLp])
) -> tuple[torch.Tensor, torch.Tensor, StepMetrics]:
    """worker_grads with the aggregation done by the segment-sum kernel.

    The forward runs in [B, L] batch space exactly as ``worker_grads``.
    The backward runs in host-sorted slot order. The FM V-gradient needs
    no per-slot V: within a segment every slot shares the key's row, so

        gV[u] = sum_s dw_s * (S_b(s) - x_s * V_u)
              = sum_s (dw_s * S_b(s))  -  V_u * sum_s (dw_s * x_s)

    — the payload is 2+K rows (dw | dw*x | dw*S; 1 row when K == 0) and
    one per-key combine against the pulled rows. Returns grads PLANAR
    [1+K, U] (the apply payload layout), py and metrics. Sums differ from
    the scatter path by float association only."""
    B, L = vals.shape
    K = rows_u.shape[1] - 1
    x_s, bidx, inv_s = ss
    rows = rows_u.index_select(0, loc.inv).reshape(B, L, K + 1)
    fwd = fm_predict(vals, rows[..., 0], rows[..., 1:])
    d, loss, correct = logit_grad_coeff(fwd.py, labels, mask)
    if K > 0:
        dS = torch.cat([d[:, None], fwd.S], dim=1)        # [B, 1+K]
        g = dS.index_select(0, bidx)                      # [BLp, 1+K]
        dw_s = g[:, 0] * x_s
        payT = torch.cat([dw_s[None, :], (dw_s * x_s)[None, :],
                          (dw_s[:, None] * g[:, 1:]).T], dim=0)
    else:
        payT = (d.index_select(0, bidx) * x_s)[None, :]
    segs = segsum_sorted(payT.contiguous(), inv_s, rows_u.shape[0])
    if K > 0:
        gV = segs[2 : 2 + K] - rows_u.T[1:] * segs[1][None, :]
        grads_p = torch.cat([segs[:1], gV], dim=0)
    else:
        grads_p = segs
    return grads_p, fwd.py, _batch_metrics(fwd.py, loss, correct, labels,
                                           mask)
