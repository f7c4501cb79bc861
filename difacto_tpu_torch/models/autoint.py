"""AutoInt: self-attentive interacting layers over the fields' embeddings
(Song, Shi, Xiao, Duan, Xu, Zhang, Tang, *AutoInt: Automatic Feature
Interaction Learning via Self-Attentive Neural Networks*, CIKM 2019), as
``loss=autoint``: its forward, its hand-written backward, its dense
weights and their Adam update.

A row's slots go into field order by their libffm field ``f_i``; the table
row of a slot gives its d = ``V_dim`` embedding ``V_i``:

    e_m = sum_{i : f_i = m} x_i V_i            (0 for a field with no slot)

Each of the ``attn_layers`` interacting layers maps the F fields' vectors
of width ``d_in`` (d, then H d') to width H d': for head h,

    a_mk = softmax_k(<W_Q^h e_m, W_K^h e_k>)   (no scaling, as published)
    e_m <- ReLU(concat_h sum_k a_mk W_V^h e_k + W_Res e_m)

and the output is the logistic margin ``py = w_out . [e_1 ; ... ; e_F] + b``. The table's linear column
w takes no part: the model gives it a zero gradient, so FTRL leaves it at
0, and only V, behind the count gate, and the dense weights train.

The dense weights live in ONE flat float32 buffer (:class:`DenseState`:
for each layer ``W_l [d_in, 4 H d']``, the columns Q | K | V | Res, then
``w_out [F H d']`` and ``b [1]``), with Adam's two moments beside it and
the step's gradient, so that Adam is a few launches over the buffer. The
backward is written out, as fm_loss_grad's and ffm_loss_grad's are: no
autograd, whose CUDA backward would run on a thread of its own. Every
matrix product is a float32 GEMM (``torch.mm``, ``torch.bmm``) with TF32
off (:func:`f32_matmuls`). Gradients are sums over the batch, the
system's convention (models/losses.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..updaters.updater import PackedFMState
from ..utils.tracing import STEP, span
from .losses import FMForward, FMGrads, logit_grad_coeff


def f32_matmuls() -> None:
    """Float32 matrix products in full float32: the card may otherwise run
    them in TF32, whose 10-bit mantissa the model's check refuses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass(frozen=True)
class Dims:
    """The model's widths: F fields, d the embedding, the layers, heads and
    head width d'."""

    F: int
    d: int
    layers: int
    heads: int
    head_dim: int

    @classmethod
    def of(cls, cfg) -> "Dims":
        a = cfg.autoint
        return cls(F=cfg.model.num_fields, d=cfg.model.V_dim,
                   layers=a.attn_layers, heads=a.attn_heads,
                   head_dim=a.attn_head_dim)

    @property
    def width(self) -> int:
        """H d': a layer's output width."""
        return self.heads * self.head_dim

    @property
    def proj(self) -> int:
        """The columns of a layer's weight: Q | K | V | Res."""
        return 4 * self.width

    def d_in(self, layer: int) -> int:
        return self.d if layer == 0 else self.width

    def shapes(self) -> dict[str, tuple[int, ...]]:
        """The dense weights in the flat buffer's order: ``attn<l>``
        [d_in, proj], ``out_w`` [F H d'], ``out_b`` [1]."""
        out = {f"attn{l}": (self.d_in(l), self.proj)
               for l in range(self.layers)}
        out["out_w"] = (self.F * self.width,)
        out["out_b"] = (1,)
        return out

    @property
    def size(self) -> int:
        return sum(math.prod(s) for s in self.shapes().values())

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Each dense weight as a view of the flat buffer ``flat``."""
        out, at = {}, 0
        for name, shape in self.shapes().items():
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
        return out


@dataclass
class DenseState:
    """The dense weights ``theta``, Adam's moments ``m`` and ``v``, and the
    gradient ``grad`` the last train step wrote, each one flat f32 [P]
    buffer on the table's device; ``step`` is Adam's t."""

    dims: Dims
    theta: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    grad: torch.Tensor
    step: int = 0

    @classmethod
    def of(cls, dims: Dims, device, theta, m=None, v=None,
           step: int = 0) -> "DenseState":
        """A state on ``device`` from the weights ``theta`` and Adam's
        moments (zero unless given), arrays or tensors anywhere, copied as
        float32."""
        def f32(x):
            return torch.as_tensor(x).to(device, torch.float32).clone()

        theta = f32(theta)
        if theta.shape != (dims.size,):
            raise ValueError(f"dense weights of shape {tuple(theta.shape)}, "
                             f"expected ({dims.size},) for {dims}")
        m, v = (torch.zeros_like(theta) if x is None else f32(x)
                for x in (m, v))
        return cls(dims, theta, m, v, torch.zeros_like(theta), int(step))


def glorot_init(dims: Dims, seed: int) -> torch.Tensor:
    """The dense weights on the host, Glorot-uniform from ``seed``: each
    projection (Q, K, V, Res of a layer: fan in d_in, fan out H d') and
    ``w_out`` (fan in F H d', fan out 1) uniform in +-sqrt(6 / (fan_in +
    fan_out)); ``b = 0``."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.zeros(dims.size, dtype=torch.float32)
    for name, w in dims.views(flat).items():
        if name == "out_b":
            continue
        fan_in, fan_out = (w.shape[0], dims.width) if w.dim() == 2 else (
            w.shape[0], 1)
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        w.copy_(torch.rand(w.shape, generator=g).mul_(2 * lim).sub_(lim))
    return flat


def init_dense(dims: Dims, seed: int, device) -> DenseState:
    return DenseState.of(dims, device, glorot_init(dims, seed))


@dataclass
class AutoIntState(PackedFMState):
    """The state of ``loss=autoint``: the row-major table (w | z | n | cnt
    | V | nV; the table kernels read it as the PackedFMState it is) and
    its dense part."""

    dense: DenseState


def adam_step(dense: DenseState, p) -> None:
    """Adam on the flat buffer from ``dense.grad``, in place, as
    TensorFlow 1's AdamOptimizer writes it (the paper's code): ``m = b1 m
    + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``theta -= lr sqrt(1 -
    b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``. ``p``: the config's
    AutoIntParam."""
    with span("difacto.dense_apply"):
        dense.step += 1
        t, b1, b2 = dense.step, p.dense_beta1, p.dense_beta2
        lr_t = p.dense_lr_eta * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        g = dense.grad
        dense.m.mul_(b1).add_(g, alpha=1.0 - b1)
        dense.v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        dense.theta.addcdiv_(dense.m, dense.v.sqrt().add_(p.dense_eps),
                             value=-lr_t)
    STEP["dense_params"] += dense.theta.numel()


def _field_segments(fields: torch.Tensor, F: int) -> torch.Tensor:
    """Each slot's (row, field) position in the [B F] field-ordered rows."""
    B = fields.shape[0]
    rows = torch.arange(B, device=fields.device)[:, None] * F
    return (rows + fields.long()).reshape(-1)


def _embed(vals, V, seg, dims: Dims) -> torch.Tensor:
    """e [B F, d]: each slot's x_i V_i summed into its row's field."""
    B, L, d = V.shape
    return V.new_zeros((B * dims.F, d)).index_add_(
        0, seg, (vals[..., None] * V).reshape(B * L, d))


def _heads(P: torch.Tensor, dims: Dims, h: int):
    """Head h's (q, k, v) [B, F, d'] as views of a layer's projections P
    [B, F, proj]."""
    w, lo = dims.width, h * dims.head_dim
    hi = lo + dims.head_dim
    return P[..., lo:hi], P[..., w + lo:w + hi], P[..., 2 * w + lo:2 * w + hi]


def _layer(X, W, dims: Dims, B: int):
    """One interacting layer on X [B F, d_in]: (P [B, F, proj], the heads'
    attention [B, F, F] each, Y [B, F, H d'])."""
    w, F = dims.width, dims.F
    P = torch.mm(X, W).view(B, F, dims.proj)
    Z = X.new_empty((B, F, w))
    As = []
    for h in range(dims.heads):
        q, k, v = _heads(P, dims, h)
        A = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1)
        lo, hi = h * dims.head_dim, (h + 1) * dims.head_dim
        torch.baddbmm(P[..., 3 * w + lo:3 * w + hi], A, v, out=Z[..., lo:hi])
        As.append(A)
    return P, As, Z.relu_()


def _stack(X, dense: DenseState, B: int, keep: bool):
    """The layers and the output on e [B F, d]: (py [B], the layers'
    (X, P, As, Y) when ``keep``)."""
    dims, W = dense.dims, dense.dims.views(dense.theta)
    kept = []
    for l in range(dims.layers):
        P, As, Y = _layer(X, W[f"attn{l}"], dims, B)
        if keep:
            kept.append((X, P, As, Y))
        X = Y.view(B * dims.F, dims.width)
    py = torch.mv(X.view(B, dims.F * dims.width), W["out_w"]) + W["out_b"]
    return py, kept


def _backward(d, kept, dense: DenseState, B: int) -> torch.Tensor:
    """Write the dense weights' gradient into ``dense.grad`` from the
    margin's coefficient ``d`` [B]; return e's gradient [B F, d]."""
    dims = dense.dims
    W, G = dims.views(dense.theta), dims.views(dense.grad)
    w, dh, F = dims.width, dims.head_dim, dims.F
    Y = kept[-1][3]
    torch.mv(Y.view(B, F * w).T, d, out=G["out_w"])
    G["out_b"].copy_(d.sum().reshape(1))
    dY = torch.outer(d, W["out_w"]).view(B, F, w)
    for l in reversed(range(dims.layers)):
        X, P, As, Y = kept[l]
        dZ = torch.ops.aten.threshold_backward(dY.view(Y.shape), Y, 0.0)
        dP = P.new_empty(P.shape)
        dP[..., 3 * w:].copy_(dZ)
        for h in range(dims.heads):
            q, k, v = _heads(P, dims, h)
            dq, dk, dv = _heads(dP, dims, h)
            A, dO = As[h], dZ[..., h * dh:(h + 1) * dh]
            dA = torch.bmm(dO, v.transpose(1, 2))
            torch.bmm(A.transpose(1, 2), dO, out=dv)
            dS = torch.ops.aten._softmax_backward_data(dA, A, -1, A.dtype)
            torch.bmm(dS, k, out=dq)
            torch.bmm(dS.transpose(1, 2), q, out=dk)
        dP = dP.view(B * F, dims.proj)
        torch.mm(X.T, dP, out=G[f"attn{l}"])
        dY = torch.mm(dP, W[f"attn{l}"].T)
    return dY


def autoint_predict(vals: torch.Tensor, V: torch.Tensor,
                    fields: torch.Tensor, dense: DenseState) -> torch.Tensor:
    """The margin py [B] alone (the eval step): the forward of
    :func:`autoint_loss_grad`, the same products in the same order."""
    seg = _field_segments(fields, dense.dims.F)
    with span("difacto.attention"):
        return _stack(_embed(vals, V, seg, dense.dims), dense,
                      vals.shape[0], False)[0]


def autoint_loss_grad(
    vals: torch.Tensor,       # f32 [B, L]
    V: torch.Tensor,          # f32 [B, L, d] the slots' embeddings
    labels01: torch.Tensor,   # f32 [B]
    mask: torch.Tensor,       # f32 [B]
    fields: torch.Tensor,     # [B, L] each slot's field < F
    dense: DenseState,
) -> tuple[FMForward, FMGrads]:
    """AutoInt's margin and gradients: per-slot ``dV = x_i de[b, f_i]``
    [B, L, d] for the per-key sums, ``dW`` zero (the linear column takes
    no part), and every dense weight's gradient written into
    ``dense.grad``. The stack, the output and their backward run in the
    span ``difacto.attention``; each call counts its rows in
    ``step.attention_rows``. ``FMForward.S`` is empty."""
    B = vals.shape[0]
    seg = _field_segments(fields, dense.dims.F)
    e = _embed(vals, V, seg, dense.dims)
    with span("difacto.attention"):
        py, kept = _stack(e, dense, B, True)
        d, loss, correct = logit_grad_coeff(py, labels01, mask)
        de = _backward(d, kept, dense, B)
    STEP["attention_rows"] += B
    dV = vals[..., None] * de.index_select(0, seg).view(V.shape)
    return (FMForward(py, vals.new_zeros((B, 0))),
            FMGrads(torch.zeros_like(vals), dV, loss, correct))
