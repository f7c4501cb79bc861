"""A plain reference of AutoInt training (``loss=autoint``), written from
the paper's equations (Song et al., *AutoInt*, CIKM 2019) and difacto's
updaters in plain ``torch``, for the tests to hold the port against. It
imports no module of this repository and no JAX.

It runs in float64 (any dtype it is given; float32 matrix products with
TF32 off, :func:`full_precision`). The gradients come from autograd on
the forward, not from a written-out backward.

One row: slot ``i`` has a table row, a value ``x_i`` and a libffm field
``f_i < F``. With ``V_r`` the table row's d factors, read as 0 until the
row's count before the step reaches ``V_threshold``:

* ``e_m = sum_{i : f_i = m} x_i V_{r_i}``, the fields in order;
* each interacting layer, for head h: ``a_mk = softmax_k(<W_Q^h e_m,
  W_K^h e_k>)``, ``e_m <- ReLU(concat_h sum_k a_mk W_V^h e_k + W_Res
  e_m)``;
* ``py = w_out . [e_1 ; ... ; e_F] + b``; loss ``log(1 + exp(-y py))``
  with ``y = 2 label - 1``, summed over the rows of the mask.

A train step sums the gradients over the batch and then updates, from
the same forward: FTRL-proximal on each touched row's w (whose gradient is
0: w takes no part), ``cnt +=`` occurrences, AdaGrad on the touched rows'
V whose count passed the gate, and Adam on the dense weights as
TensorFlow 1's AdamOptimizer writes it.

The dense weights are one flat vector in the port's order: for each layer
``W_l [d_in, proj]`` (row-major; the columns Q | K | V | Res, each
``heads * head_dim`` wide and head h at ``h * head_dim`` within each),
then ``w_out [F * heads * head_dim]`` (field-major), then ``b``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def full_precision() -> None:
    """Float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Widths:
    F: int
    d: int
    layers: int = 3
    heads: int = 2
    head_dim: int = 32

    @property
    def width(self) -> int:
        return self.heads * self.head_dim

    def weights(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        """The flat vector's weights by name (views)."""
        parts = [(f"attn{l}", (self.d if l == 0 else self.width,
                               4 * self.width))
                 for l in range(self.layers)]
        parts += [("out_w", (self.F * self.width,)), ("out_b", (1,))]
        out, at = {}, 0
        for name, shape in parts:
            n = math.prod(shape)
            out[name] = theta[at:at + n].view(shape)
            at += n
        assert at == theta.numel(), "the flat vector is not of these widths"
        return out


def field_embeddings(Vs, vals, fields, F: int) -> torch.Tensor:
    """e [B, F, d] from the slots' factors Vs [B, L, d], values and
    fields, by a one-hot product."""
    onehot = torch.nn.functional.one_hot(fields.long(), F).to(Vs.dtype)
    return torch.einsum("blf,bld->bfd", onehot, vals[..., None] * Vs)


def margins(e: torch.Tensor, theta: torch.Tensor, w: Widths) -> torch.Tensor:
    """py [B] of the field embeddings e [B, F, d]."""
    W = w.weights(theta)
    dh, hw = w.head_dim, w.width
    for l in range(w.layers):
        Wl = W[f"attn{l}"]
        heads = []
        for h in range(w.heads):
            cols = slice(h * dh, (h + 1) * dh)
            q = e @ Wl[:, cols]
            k = e @ Wl[:, hw:][:, cols]
            v = e @ Wl[:, 2 * hw:][:, cols]
            a = torch.softmax(q @ k.transpose(1, 2), dim=-1)
            heads.append(a @ v)
        e = torch.relu(torch.cat(heads, dim=-1) + e @ Wl[:, 3 * hw:])
    return e.reshape(e.shape[0], -1) @ W["out_w"] + W["out_b"]


def logloss(py, labels, mask) -> torch.Tensor:
    """The summed ``log(1 + exp(-y py))``, by ``logaddexp``: smooth, so
    that autograd's gradient at ``py = 0`` is ``-y / 2``."""
    y = 2.0 * labels - 1.0
    return (torch.logaddexp(torch.zeros_like(py), -y * py) * mask).sum()


def loss_and_grads(Vs, vals, fields, labels, mask, theta, w: Widths):
    """(py [B], the summed loss, dloss/dVs [B, L, d], dloss/dtheta), by
    autograd."""
    full_precision()
    Vs = Vs.detach().clone().requires_grad_(True)
    theta = theta.detach().clone().requires_grad_(True)
    py = margins(field_embeddings(Vs, vals, fields, w.F), theta, w)
    loss = logloss(py, labels, mask)
    gV, gt = torch.autograd.grad(loss, (Vs, theta))
    return py.detach(), loss.detach(), gV, gt


@dataclass
class Hyper:
    lr_eta: float = 0.01
    lr_beta: float = 1.0
    l1: float = 1.0
    l2: float = 0.1
    V_lr_eta: float = 0.01
    V_lr_beta: float = 1.0
    V_l2: float = 0.0001
    V_threshold: float = 2.0
    dense_lr_eta: float = 0.001
    dense_beta1: float = 0.9
    dense_beta2: float = 0.999
    dense_eps: float = 1e-8


class Trainer:
    """The whole table (``w, z, n, cnt`` [N], ``V, nV`` [N, d]) and the
    dense weights with Adam's ``m``, ``v`` and step ``t`` (zero unless
    given), in ``dtype``."""

    def __init__(self, table: dict, theta, widths: Widths, hyper: Hyper,
                 dtype=torch.float64, m=None, v=None, t: int = 0):
        def f(x):
            return torch.as_tensor(x).to(dtype).clone()

        self.w, self.z, self.n, self.cnt = (f(table[k])
                                            for k in ("w", "z", "n", "cnt"))
        self.V, self.nV = f(table["V"]), f(table["nV"])
        self.theta = f(theta)
        self.m = torch.zeros_like(self.theta) if m is None else f(m)
        self.v = torch.zeros_like(self.theta) if v is None else f(v)
        self.t = t
        self.widths, self.h, self.dtype = widths, hyper, dtype

    def step(self, rows, vals, fields, labels, mask):
        """One train step on table rows ``rows`` [B, L]; returns (py, the
        summed loss)."""
        h, dt = self.h, self.dtype
        vals, labels, mask = (torch.as_tensor(a).to(dt)
                              for a in (vals, labels, mask))
        rows = torch.as_tensor(rows).long()
        real = rows >= 0                                 # PAD_ID is -1
        gate = (self.cnt >= h.V_threshold).to(dt)
        Vs = (self.V * gate[:, None])[rows.clamp(min=0)]
        py, loss, gV, gt = loss_and_grads(Vs, vals, torch.as_tensor(fields),
                                          labels, mask, self.theta,
                                          self.widths)
        N = self.w.shape[0]
        flat = torch.where(real, rows, N).reshape(-1)   # pads to a spare row
        gv = torch.zeros((N + 1, self.V.shape[1]), dtype=dt).index_add_(
            0, flat, gV.reshape(flat.shape[0], -1))[:N]
        occ = torch.zeros(N + 1, dtype=dt).index_add_(
            0, flat, torch.ones(flat.shape[0], dtype=dt))[:N]
        hit = occ > 0
        g = torch.zeros(N, dtype=dt)                    # w takes no part
        n_new = self.n + g * g
        sigma = (n_new.sqrt() - self.n.sqrt()) / h.lr_eta
        z_new = self.z + g - sigma * self.w
        w_new = torch.where(
            z_new.abs() <= h.l1, torch.zeros_like(z_new),
            -(z_new - z_new.sign() * h.l1)
            / ((h.lr_beta + n_new.sqrt()) / h.lr_eta + h.l2))
        self.w = torch.where(hit, w_new, self.w)
        self.z = torch.where(hit, z_new, self.z)
        self.n = torch.where(hit, n_new, self.n)
        act = (hit & (gate > 0))[:, None]
        gr = gv + h.V_l2 * self.V
        nv_new = self.nV + gr * gr
        v_new = self.V - h.V_lr_eta * gr / (nv_new.sqrt() + h.V_lr_beta)
        self.V = torch.where(act, v_new, self.V)
        self.nV = torch.where(act, nv_new, self.nV)
        self.cnt = self.cnt + occ
        self.t += 1
        b1, b2 = h.dense_beta1, h.dense_beta2
        self.m = b1 * self.m + (1 - b1) * gt
        self.v = b2 * self.v + (1 - b2) * gt * gt
        lr_t = h.dense_lr_eta * math.sqrt(1 - b2 ** self.t) / (1 - b1 ** self.t)
        self.theta = self.theta - lr_t * self.m / (self.v.sqrt()
                                                   + h.dense_eps)
        return py, loss
