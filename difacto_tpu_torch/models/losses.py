"""Losses: logistic, factorization-machine and field-aware FM, as
batch-local math.

Port of ``difacto_tpu/models/losses.py`` (reference:
``src/loss/fm_loss.h`` :: FMLoss and ``src/loss/logit_loss.h`` ::
LogitLoss; FFM has no reference file, it is the libffm model). Every batch is a dense padded ``[B, L]`` block; padding slots
carry vals == 0 and contribute nothing. Gradient convention matches the
reference: labels y in {-1,+1}, per-example loss log(1+exp(-y*py)),
gradients are SUMS over the batch (no 1/B averaging).

The FM second-order term is the classic sum-of-squares minus
square-of-sums:  py = <w, x> + 1/2 * sum_k [ (sum_i x_i V_ik)^2
                                             - sum_i x_i^2 V_ik^2 ].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def stable_logloss(margin: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(margin)), overflow-safe (margin = -y * py)."""
    return torch.log1p(torch.exp(-torch.abs(margin))) + torch.clamp(margin, min=0.0)


class FMForward(NamedTuple):
    py: torch.Tensor     # f32 [B] raw margin
    S: torch.Tensor      # f32 [B, K] sum_i x_i * V_ik (residual for grad)


def fm_predict(vals: torch.Tensor, W: torch.Tensor, V: torch.Tensor) -> FMForward:
    """vals, W: f32 [B, L]; V: f32 [B, L, K] (K may be 0)."""
    linear = torch.sum(vals * W, dim=-1)
    if V.shape[-1] == 0:
        return FMForward(linear, vals.new_zeros((vals.shape[0], 0)))
    xv = vals[..., None] * V                       # [B, L, K]
    S = torch.sum(xv, dim=1)                       # [B, K]
    Q = torch.sum(xv * xv, dim=1)                  # [B, K] == sum x^2 V^2
    py = linear + 0.5 * torch.sum(S * S - Q, dim=-1)
    return FMForward(py, S)


class FMGrads(NamedTuple):
    dW: torch.Tensor      # f32 [B, L]
    dV: torch.Tensor      # f32 [B, L, K]
    loss: torch.Tensor    # f32 [B] per-example logloss (0 on masked rows)
    correct: torch.Tensor # f32 [B] 1 where sign-correct


def logit_grad_coeff(py: torch.Tensor, labels01: torch.Tensor,
                     mask: torch.Tensor):
    """d l/d py for l = log(1+exp(-y*py)), y = 2*labels01 - 1: equals
    sigma(py) - labels01 (reference: LogitLoss::CalcGrad)."""
    y = 2.0 * labels01 - 1.0
    loss = stable_logloss(-y * py) * mask
    d = (torch.sigmoid(py) - labels01) * mask
    correct = ((py > 0) == (labels01 > 0.5)).to(py.dtype) * mask
    return d, loss, correct


def fm_loss_grad(
    vals: torch.Tensor,
    W: torch.Tensor,
    V: torch.Tensor,
    labels01: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[FMForward, FMGrads]:
    """Fused predict + gradient (reference: FMLoss::Predict then CalcGrad)."""
    fwd = fm_predict(vals, W, V)
    d, loss, correct = logit_grad_coeff(fwd.py, labels01, mask)
    dW = vals * d[:, None]
    if V.shape[-1] == 0:
        dV = torch.zeros_like(V)
    else:
        # d py / d V_ik = x_i * (S_k - x_i V_ik)
        dV = d[:, None, None] * vals[:, :, None] * (
            fwd.S[:, None, :] - vals[:, :, None] * V
        )
    return fwd, FMGrads(dW, dV, loss, correct)


# ---------------------------------------------------------------------------
# field-aware FM: py = <w,x> + sum_{i<j} x_i x_j <V_i[f_j], V_j[f_i]>
# ---------------------------------------------------------------------------


def _ffm_spans(L: int, block: int) -> list[tuple[int, int]]:
    """The slot ranges of the i axis the cross terms are streamed in: one
    range (dense) unless ``0 < block < L``. The last range may be short:
    a Python loop needs no padding where ``lax.scan`` did."""
    if not block or block >= L:
        return [(0, L)]
    return [(i0, min(i0 + block, L)) for i0 in range(0, L, block)]


def _ffm_field_index(fields, F: int, L: int):
    """Clipped long field ids [B, L], or None when slot position is the
    field (then F must equal L)."""
    if fields is None:
        assert F == L, "slot-position ffm needs F == L"
        return None
    return fields.clamp(0, F - 1).long()


def _ffm_cross(vals, V4, idx, i0: int, i1: int):
    """Rows i0..i1 of the cross terms: M [B, n, L] = x_i x_j with the
    diagonal i == j zeroed, A [B, n, L, K] = V_i[f_j] and At [B, n, L, K] =
    V_j[f_i]."""
    B, L = vals.shape
    K = V4.shape[3]
    n = i1 - i0
    if idx is None:
        A = V4[:, i0:i1]                               # f_j = j
        At = V4[:, :, i0:i1].transpose(1, 2)           # f_i = i
    else:
        A = torch.gather(V4[:, i0:i1], 2,
                         idx[:, None, :, None].expand(B, n, L, K))
        At = torch.gather(V4, 2, idx[:, None, i0:i1, None].expand(
            B, L, n, K)).transpose(1, 2)
    ii = torch.arange(i0, i1, device=vals.device)
    jj = torch.arange(L, device=vals.device)
    M = (vals[:, i0:i1, None] * vals[:, None, :]) * (
        ii[:, None] != jj[None, :]).to(vals.dtype)
    return M, A, At


def _ffm_to_fields(G, idx, F: int):
    """dV4 slab [B, n, F, K] from G [B, n, L(j), K]: G's j axis summed into
    the field axis, a segment sum over (b, f_j) by ``index_add_`` (no
    matmul, so no TF32 anywhere)."""
    B, n, L, K = G.shape
    seg = (torch.arange(B, device=G.device)[:, None] * F + idx).reshape(-1)
    Gj = G.permute(0, 2, 1, 3).reshape(B * L, n * K)   # leading axis (b, j)
    out = G.new_zeros((B * F, n * K)).index_add_(0, seg, Gj)
    return out.reshape(B, F, n, K).transpose(1, 2)


def _ffm_margin(vals, W, V4, idx, spans, keep: bool):
    """py [B], streamed over ``spans``; with ``keep`` (one span) also the
    span's (M, At) for the backward."""
    py = torch.sum(vals * W, dim=-1)
    kept = None
    for i0, i1 in spans:
        M, A, At = _ffm_cross(vals, V4, idx, i0, i1)
        py = py + 0.5 * torch.sum(M * torch.sum(A * At, dim=-1), dim=(1, 2))
        if keep:
            kept = (M, At)
    return py, kept


def ffm_predict(vals: torch.Tensor, W: torch.Tensor, V4: torch.Tensor,
                fields: torch.Tensor | None = None,
                block: int = 0) -> torch.Tensor:
    """The FFM margin py [B] alone (the eval step): the forward of
    :func:`ffm_loss_grad`, the same sums in the same order."""
    B, L = vals.shape
    idx = _ffm_field_index(fields, V4.shape[2], L)
    return _ffm_margin(vals, W, V4, idx, _ffm_spans(L, block), False)[0]


def ffm_loss_grad(
    vals: torch.Tensor,      # f32 [B, L]
    W: torch.Tensor,         # f32 [B, L]
    V4: torch.Tensor,        # f32 [B, L, F, K]
    labels01: torch.Tensor,
    mask: torch.Tensor,
    fields: torch.Tensor | None = None,  # i64/i32 [B, L] field id < F
    block: int = 0,          # > 0: the i axis in block-slot chunks
) -> tuple[FMForward, FMGrads]:
    """Field-aware FM: py = <w,x> + sum_{i<j} x_i x_j <V_i[f_j], V_j[f_i]>.

    Port of ``difacto_tpu/models/losses.py::ffm_loss_grad`` and
    ``::_ffm_loss_grad_blocked``. Two field sources: ``fields=None``, slot
    position is the field (F must equal L: fixed-schema CTR rows written
    in field order); or explicit per-slot ``fields`` (libffm
    ``field:idx:val``; padding slots carry vals == 0, so their field id
    does not matter). The cost is O(B L^2 K). ``block`` streams the i
    axis in chunks, a Python loop where the JAX function runs ``lax.scan``:
    a first pass sums py (the gradient coefficient needs the whole
    margin), a second recomputes each chunk's cross terms and emits its
    dV4 slab, so the peak holds ~3 [B, block, L, K] tensors instead of ~6
    [B, L, L, K]. Sums differ from the dense path by float association
    only. ``FMForward.S`` is empty: FFM has no per-example factor sum."""
    B, L = vals.shape
    F = V4.shape[2]
    idx = _ffm_field_index(fields, F, L)
    spans = _ffm_spans(L, block)
    dense = len(spans) == 1
    py, kept = _ffm_margin(vals, W, V4, idx, spans, dense)
    d, loss, correct = logit_grad_coeff(py, labels01, mask)
    dW = vals * d[:, None]
    # dL/dV4[b, i, f, k] = d * sum_{j != i, f_j == f} x_i x_j V_j[f_i][k]
    slabs = []
    for i0, i1 in spans:
        if dense:
            M, At = kept
        else:
            M, _, At = _ffm_cross(vals, V4, idx, i0, i1)
        G = (d[:, None, None] * M)[..., None] * At     # [B, n, L, K]
        slabs.append(G if idx is None else _ffm_to_fields(G, idx, F))
    dV4 = slabs[0] if dense else torch.cat(slabs, dim=1)
    fwd = FMForward(py, vals.new_zeros((B, 0)))
    return fwd, FMGrads(dW, dV4, loss, correct)
