"""Worker-side batch math of the train and eval steps.

Port of ``difacto_tpu/learners/step.py`` (reference:
the body of ``src/sgd/sgd_learner.h`` :: SGDLearner::Process — pull ->
Loss::Predict/CalcGrad -> per-key gradient aggregation -> push). The
store (parallel/store.py) decides where the table rows come from and
where the gradients go; the math here is the same for both.

Two per-key aggregations:

* :func:`worker_grads` — the scatter path (``segsum=scatter``, and
  ``kernel=pallas``'s default), with ``index_add_``;
* :func:`worker_grads_sorted` — the sorted path (``segsum=sorted``, and
  ``kernel=pairs``'s default): the backward runs in host-sorted slot
  order and the per-key sums come from the segment-sum kernels
  (ops/segsum.py: FM's fused kernel, or B3); :func:`derive_sorted_slots`
  rebuilds its sorted stream on the device from a compact batch
  (``cache_compact``).

Each marks its forward and backward on the batch's rows (the rows
gather, the loss, its metrics) as the span ``difacto.loss`` and the
per-key sums (FM's fused kernel; or the payload, B3 or ``index_add_``,
the combine) as ``difacto.keysum`` (utils/tracing.py).

``loss`` is ``fm`` (K = 0 is logit), ``ffm``: then a row's K = F*k
factors are F field blocks of k (F = ``num_fields``, or L when slot
position is the field) and the math is models/losses.py::ffm_loss_grad,
streamed in ``ffm_block``-slot chunks when that is set; or ``autoint``:
a row's K factors are its embedding, and the math is
models/autoint.py::autoint_loss_grad over the state's dense part
(``dense``), whose gradient it writes into ``dense.grad``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.autoint import autoint_loss_grad, autoint_predict
from ..models.losses import (ffm_loss_grad, ffm_predict, fm_loss_grad,
                             fm_predict, logit_grad_coeff)
from ..ops.localize import Localized
from ..ops.metrics import NUM_AUC_BINS, auc_hist_update
from ..ops.segsum import segsum_fm, segsum_sorted
from ..utils.tracing import span


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


def _rows(rows_u: torch.Tensor, loc: Localized, B: int, L: int):
    """The batch's [B, L, 1+K] rows, gathered from the unique rows."""
    return rows_u.index_select(0, loc.inv).reshape(B, L, rows_u.shape[1])


def _ffm_factors(rows: torch.Tensor, num_fields: int) -> torch.Tensor:
    """V4 [B, L, F, k] from the rows' K = F*k factors."""
    B, L, D = rows.shape
    F = num_fields or L
    assert (D - 1) % F == 0, "ffm rows must be [U, 1 + F*k]"
    return rows[..., 1:].reshape(B, L, F, (D - 1) // F)


def _loss_grad(rows, vals, labels, mask, loss, fields, num_fields,
               ffm_block, dense):
    """The loss's forward and per-slot gradients on the batch's rows."""
    if loss == "autoint":
        return autoint_loss_grad(vals, rows[..., 1:], labels, mask, fields,
                                 dense)
    if loss == "ffm":
        return ffm_loss_grad(vals, rows[..., 0],
                             _ffm_factors(rows, num_fields), labels, mask,
                             fields=fields, block=ffm_block)
    return fm_loss_grad(vals, rows[..., 0], rows[..., 1:], labels, mask)


def worker_forward(
    rows_u: torch.Tensor,  # f32 [U, 1+K] pulled unique rows (w | V)
    loc: Localized,
    vals: torch.Tensor,    # f32 [B, L]
    labels: torch.Tensor,  # f32 [B] in {0,1}
    mask: torch.Tensor,    # f32 [B]
    *,
    loss: str = "fm",      # fm | ffm | autoint (fm with K = 0 is logit)
    fields: torch.Tensor | None = None,  # [B, L] explicit fields
    num_fields: int = 0,   # ffm field count F (0: F = L, slot position)
    ffm_block: int = 0,    # ffm: chunked cross terms (0 = dense)
    dense=None,            # autoint: the state's DenseState
) -> tuple[torch.Tensor, StepMetrics]:
    """The eval step's math: forward only (the JAX store's eval runs the
    whole loss and keeps its forward: the same margins). Returns (py [B],
    metrics)."""
    B, L = vals.shape
    with span("difacto.loss"):
        rows = _rows(rows_u, loc, B, L)
        if loss == "autoint":
            py = autoint_predict(vals, rows[..., 1:], fields, dense)
        elif loss == "ffm":
            py = ffm_predict(vals, rows[..., 0],
                             _ffm_factors(rows, num_fields), fields=fields,
                             block=ffm_block)
        else:
            py = fm_predict(vals, rows[..., 0], rows[..., 1:]).py
        _, lossv, correct = logit_grad_coeff(py, labels, mask)
        return py, _batch_metrics(py, lossv, correct, labels, mask)


def worker_grads(
    rows_u: torch.Tensor,  # f32 [U, 1+K] pulled unique rows (w | V)
    loc: Localized,
    vals: torch.Tensor,    # f32 [B, L]
    labels: torch.Tensor,  # f32 [B] in {0,1}
    mask: torch.Tensor,    # f32 [B]
    *,
    loss: str = "fm",
    fields: torch.Tensor | None = None,
    num_fields: int = 0,
    ffm_block: int = 0,
    dense=None,
) -> tuple[torch.Tensor, torch.Tensor, StepMetrics]:
    """Per-unique-id aggregated gradients by scatter-add. Returns
    (grads_u [U, 1+K], py [B], metrics). The loss keywords are those of
    :func:`worker_forward`."""
    B, L = vals.shape
    U, D = rows_u.shape
    with span("difacto.loss"):
        fwd, g = _loss_grad(_rows(rows_u, loc, B, L), vals, labels, mask,
                            loss, fields, num_fields, ffm_block, dense)
        metrics = _batch_metrics(fwd.py, g.loss, g.correct, labels, mask)
    with span("difacto.keysum"):
        flat = torch.cat([g.dW.reshape(B * L, 1),
                          g.dV.reshape(B * L, D - 1)], dim=1)
        grads_u = torch.zeros((U, D), dtype=flat.dtype, device=flat.device)
        grads_u.index_add_(0, loc.inv, flat)
    return grads_u, fwd.py, metrics


def derive_sorted_slots(
    vals: torch.Tensor,    # f32 [B, L]
    inv: torch.Tensor,     # i32 [B*L] slot -> unique lane
    slot_s: torch.Tensor,  # i32 [BLp] the sort permutation, pads 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sorted stream of a compact batch (``cache_compact``), derived
    where its arrays lie from ``vals``, ``inv`` and the sort permutation,
    as the JAX store derives it (``store.py:539-551``): (x_sorted f32,
    bidx i32, inv_sorted i32), each [BLp] and element for element the
    host's full form (data/prep.py::build_sorted_slots). Pad slots carry
    x = 0, example 0 and the LAST real slot's lane. The JAX package gives
    them lane ``inv[0]``, harmless there because its kernel reads a
    host-built schedule; the port's B3 finds segments by comparing
    adjacent lanes, so a pad lane below the last real one would open a
    second segment of lane ``inv[0]``, whose zero sum could overwrite the
    first's."""
    bl = vals.numel()
    x_s = vals.reshape(-1).index_select(0, slot_s)
    x_s[bl:] = 0.0
    inv_s = inv.index_select(0, slot_s)
    inv_s[bl:] = inv_s[bl - 1]
    return x_s, slot_s // vals.shape[1], inv_s


def worker_grads_sorted(
    rows_u: torch.Tensor,  # f32 [U, 1+K] pulled unique rows (w | V)
    loc: Localized,
    vals: torch.Tensor,    # f32 [B, L]
    labels: torch.Tensor,  # f32 [B]
    mask: torch.Tensor,    # f32 [B]
    ss: tuple,             # (x_sorted [BLp], bidx [BLp], inv_sorted [BLp])
    *,
    loss: str = "fm",
    fields: torch.Tensor | None = None,
    num_fields: int = 0,
    ffm_block: int = 0,
    slot_s: torch.Tensor | None = None,  # i32 [BLp] flat slot of each
                           # sorted slot (the sort permutation; ffm and
                           # autoint only)
    dense=None,
) -> tuple[torch.Tensor, torch.Tensor, StepMetrics]:
    """worker_grads with the aggregation done by the segment-sum kernel.

    The forward runs in [B, L] batch space exactly as ``worker_grads``.
    The backward runs in host-sorted slot order. The FM V-gradient needs
    no per-slot V: within a segment every slot shares the key's row, so

        gV[u] = sum_s dw_s * (S_b(s) - x_s * V_u)
              = sum_s (dw_s * S_b(s))  -  V_u * sum_s (dw_s * x_s)

    — the payload is 2+K rows (dw | dw*x | dw*S) and one per-key combine
    against the pulled rows. With K > 0 ops/segsum.py::segsum_fm does all
    of it: on the card one fused kernel builds the payload from ``d``,
    ``S`` and the sorted stream in registers and writes the combined
    gradient; on the CPU the composition (gather, payload, segment sum,
    combine), with the same bits. K == 0 (logit) sums the one row d*x by
    the segment-sum kernel. FFM's and AutoInt's per-slot gradients have no
    such factoring (a slot's gradient depends on its field-crossed
    partners, or on the whole row through the attention) and their losses
    have them in batch space already: the payload is the 1+K rows of each
    slot's gradient gathered by ``slot_s``, pads zeroed, summed by the
    segment-sum kernel with no combine. Returns grads
    PLANAR [1+K, U] (the apply payload layout), py and metrics. Sums
    differ from the scatter path by float association only."""
    B, L = vals.shape
    K = rows_u.shape[1] - 1
    x_s, bidx, inv_s = ss
    if loss in ("ffm", "autoint"):
        with span("difacto.loss"):
            fwd, g = _loss_grad(_rows(rows_u, loc, B, L), vals, labels,
                                mask, loss, fields, num_fields, ffm_block,
                                dense)
            metrics = _batch_metrics(fwd.py, g.loss, g.correct, labels,
                                     mask)
        with span("difacto.keysum"):
            flat = torch.cat([g.dW.reshape(B * L, 1),
                              g.dV.reshape(B * L, K)], dim=1)
            real = torch.arange(slot_s.shape[0], device=flat.device) < B * L
            pay = torch.where(real[:, None],
                              flat.index_select(0, slot_s.long()), 0.0)
            grads_p = segsum_sorted(pay.T.contiguous(), inv_s,
                                    rows_u.shape[0])
        return grads_p, fwd.py, metrics
    with span("difacto.loss"):
        rows = _rows(rows_u, loc, B, L)
        fwd = fm_predict(vals, rows[..., 0], rows[..., 1:])
        d, lossv, correct = logit_grad_coeff(fwd.py, labels, mask)
        metrics = _batch_metrics(fwd.py, lossv, correct, labels, mask)
    with span("difacto.keysum"):
        if K > 0:
            grads_p = segsum_fm(d, fwd.S, x_s, bidx, inv_s, rows_u)
        else:
            payT = (d.index_select(0, bidx) * x_s)[None, :]
            grads_p = segsum_sorted(payT.contiguous(), inv_s,
                                    rows_u.shape[0])
    return grads_p, fwd.py, metrics
