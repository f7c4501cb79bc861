"""Losses: logistic and factorization-machine, as batch-local math.

Port of the fm/logit half of ``difacto_tpu/models/losses.py`` (reference:
``src/loss/fm_loss.h`` :: FMLoss and ``src/loss/logit_loss.h`` ::
LogitLoss). Every batch is a dense padded ``[B, L]`` block; padding slots
carry vals == 0 and contribute nothing. Gradient convention matches the
reference: labels y in {-1,+1}, per-example loss log(1+exp(-y*py)),
gradients are SUMS over the batch (no 1/B averaging).

The FM second-order term is the classic sum-of-squares minus
square-of-sums:  py = <w, x> + 1/2 * sum_k [ (sum_i x_i V_ik)^2
                                             - sum_i x_i^2 V_ik^2 ].
FFM waits (ROADMAP A8).
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
