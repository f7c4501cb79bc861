"""AutoInt (``loss=autoint``; Song et al., *AutoInt: Automatic Feature
Interaction Learning via Self-Attentive Neural Networks*, CIKM 2019): the
fields' d = ``V_dim`` embeddings from FM's hashed table, three interacting
layers of self-attention over them, a linear output, AdaGrad on the
embeddings (behind the count gate) and Adam on the dense weights.

A row's slots go into field order by their libffm field: ``e_m = sum_{i :
f_i = m} x_i V_i``. Each layer, for head h: ``a_mk = softmax_k(<W_Q^h e_m,
W_K^h e_k>)``, ``e_m <- ReLU(concat_h sum_k a_mk W_V^h e_k + W_Res e_m)``;
then ``py = w_out . [e_1 ; ... ; e_F] + b``. The table's w takes no part
(its gradient is 0, so FTRL leaves it at 0).

The module's parts, as the harness asks for them (PERF.md §4): ``Model``
(FM's table, fmbench/reference.py's ``Table``, and the widths and Adam's
settings), ``place``, ``keep``, ``reference``, ``LEAVES`` and the counts.
The reference is fmbench/reference.py's ``steps`` (the table's updaters,
the loss, the readings) with this model's margin and gradients: plain
PyTorch, autograd over the written-out forward, in blocks of rows so that
float64 fits the card, and Adam on the dense weights as TensorFlow 1's
AdamOptimizer writes it. It imports nothing of the program.

The dense weights are one flat vector, in the program's order
(models/autoint.py's ``Dims``): for each layer ``W_l [d_in, 4 H d']``
(row-major; the columns Q | K | V | Res, head h at ``h d'`` within each),
then ``w_out [F H d']`` (field-major), then ``b``. Their leaves for the
check: ``attn0``, ``attn1``, ``attn2`` (each layer's W) and ``out``
(``w_out`` and ``b``); each reads ``grad_`` and ``change_`` (the norm of
the weights' change after the last checked step), beside FM's
``change_w`` and ``change_V``, and ``grad_V``, AdaGrad's ``sqrt(sum nV)``
after step 1 (with ``V_threshold`` 0 every row passes the gate in the
first step; FM reads it after step 2). A dense leaf's ``grad_`` is of
Adam's state after step 1 (:func:`grad_reading`): ``sqrt(sum v) sqrt(1 +
cos(m, r))``, the gradient's norm, and through the first moment m its
direction against r, a unit vector a leaf drawn from the seed
(:func:`directions`), to about ``1 / sqrt(n)`` of the norm for a leaf of
n weights; a norm alone reads a gradient turned or shuffled within a leaf
the same, and Adam's first steps, ~``lr sign(g)`` a weight, hardly show
it in ``change``. Both ``grad`` readings are of the first step, from the
state ``place`` wrote: from the second on, those steps part a float32
state from a float64 one wherever a gradient lies near ``eps / sqrt(1 -
b2)``, which the ``change`` readings take in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from fmbench import counts, traffic
from fmbench import reference as plain
from fmbench.models import fm

ATTN = ("attn0", "attn1", "attn2")
DENSE = ATTN + ("out",)
LEAVES = ("w", "V") + DENSE
# rows a block of the reference's forward and backward (float64 at ~360 KB
# of activations a row)
BLOCK_ROWS = 8192


@dataclass
class Model(plain.Table):
    F: int = 0
    heads: int = 0
    head_dim: int = 0
    dense_lr_eta: float = 0.0
    beta1: float = 0.0
    beta2: float = 0.0
    eps: float = 0.0

    @classmethod
    def of(cls, conf: dict) -> "Model":
        if int(conf["attn_layers"]) != len(ATTN):
            raise ValueError(f"the benchmark's AutoInt has {len(ATTN)} "
                             f"layers, the configuration "
                             f"{conf['attn_layers']}")
        return cls(num_bits=int(conf["num_bits"]), K=int(conf["V_dim"]),
                   init_scale=float(conf["V_init_scale"]),
                   **plain.Table.updaters(conf),
                   F=int(conf["num_fields"]), heads=int(conf["attn_heads"]),
                   head_dim=int(conf["attn_head_dim"]),
                   dense_lr_eta=float(conf["dense_lr_eta"]),
                   beta1=float(conf["dense_beta1"]),
                   beta2=float(conf["dense_beta2"]),
                   eps=float(conf["dense_eps"]))

    @property
    def width(self) -> int:
        return self.heads * self.head_dim

    def shapes(self) -> dict[str, tuple[int, ...]]:
        """The flat vector's weights in order."""
        out = {name: (self.K if l == 0 else self.width, 4 * self.width)
               for l, name in enumerate(ATTN)}
        out["out_w"] = (self.F * self.width,)
        out["out_b"] = (1,)
        return out

    def leaves(self) -> dict[str, slice]:
        """Each check leaf's span of the flat vector."""
        out, at = {}, 0
        for name, shape in self.shapes().items():
            n = math.prod(shape)
            out[name] = slice(at, at + n)
            at += n
        out["out"] = slice(out.pop("out_w").start, out.pop("out_b").stop)
        return out

    @property
    def size(self) -> int:
        return sum(math.prod(s) for s in self.shapes().values())

    def margins(self, e: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """py [B] of the field embeddings e [B, F, d]."""
        W, at = {}, 0
        for name, shape in self.shapes().items():
            W[name] = theta[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
        dh, hw = self.head_dim, self.width
        for name in ATTN:
            Wl, heads = W[name], []
            for h in range(self.heads):
                cols = slice(h * dh, (h + 1) * dh)
                q = e @ Wl[:, cols]
                k = e @ Wl[:, hw:][:, cols]
                v = e @ Wl[:, 2 * hw:][:, cols]
                heads.append(torch.softmax(q @ k.transpose(1, 2), -1) @ v)
            e = torch.relu(torch.cat(heads, dim=-1) + e @ Wl[:, 3 * hw:])
        return e.reshape(e.shape[0], -1) @ W["out_w"] + W["out_b"]


def initial_dense(seed: int, m: Model, device) -> torch.Tensor:
    """The benchmark's initial dense weights: Glorot-uniform (each of a
    layer's Q, K, V, Res: fan in d_in, fan out H d'; ``w_out``: fan in
    F H d', fan out 1), ``b = 0``, from a generator of its own."""
    g = traffic.generator(seed ^ 0x2545F491, device)
    parts = []
    for name, shape in m.shapes().items():
        if name == "out_b":
            parts.append(torch.zeros(1, device=device))
            continue
        fan_in = shape[0]
        fan_out = m.width if len(shape) == 2 else 1
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=g, device=device)
        parts.append(u.mul_(2.0 * lim).sub_(lim).reshape(-1))
    return torch.cat(parts)


def directions(seed: int, m: Model, device) -> torch.Tensor:
    """r [P] float64: normal from a generator of its own, each dense
    leaf's span of it scaled to unit norm."""
    g = traffic.generator(seed ^ 0x5DEECE66, device)
    r = torch.randn(m.size, generator=g, device=device, dtype=torch.float64)
    for sl in m.leaves().values():
        r[sl] /= torch.linalg.vector_norm(r[sl])
    return r


def grad_reading(v, mom, r) -> torch.Tensor:
    """A dense leaf's ``grad_`` from Adam's moments ``v``, ``mom`` after
    step 1 and the leaf's unit direction ``r``, in float64: ``sqrt(sum v)
    sqrt(1 + cos(mom, r))``. A gradient with its sign turned reads ``sqrt(1
    - cos)`` for ``sqrt(1 + cos)``; an unchanged state (``mom = v = 0``)
    reads 0."""
    v, mom = v.double(), mom.double()
    cos = mom @ r / torch.linalg.vector_norm(mom).clamp_min(1e-300)
    return v.sum().sqrt() * (1.0 + cos).sqrt()


def place(learner, seed: int, device, m: Model) -> dict:
    """FM's table (``w = z = n = cnt = nV = 0``, ``V = V0``) and the dense
    part: the weights of :func:`initial_dense`, Adam's moments and step
    zero."""
    kept = fm.place(learner, seed, device, m)
    d = learner.state.dense
    theta0 = initial_dense(seed, m, device)
    d.theta.copy_(theta0)
    d.m.zero_()
    d.v.zero_()
    d.step = 0
    kept.update(theta0=theta0, leaves=m.leaves(),
                dirs=directions(seed, m, device))
    return kept


def keep(kept: dict, state, metrics, call: int) -> None:
    """Each step's summed logloss; after step 1, AdaGrad's ``sqrt(sum
    nV)`` and each dense leaf's :func:`grad_reading`; after the last,
    ``|w|``, ``|V - V0|`` and the norm of each dense leaf's change."""
    kept["loss"].append(metrics.logloss_sum.double())
    d = state.dense
    if call == 1:
        kept["grad_V"] = state.nV.double().sum().sqrt()
        r = kept.pop("dirs")
        for name, sl in kept["leaves"].items():
            kept[f"grad_{name}"] = grad_reading(d.v[sl], d.m[sl], r[sl])
    if call == plain.CHECKED_STEPS:
        kept["change_w"] = torch.linalg.vector_norm(state.w.double())
        V0, V = kept.pop("V0"), state.V
        acc = torch.zeros((), dtype=torch.float64, device=V0.device)
        for lo in range(0, V0.shape[0], 1 << 18):
            dv = (V[:, lo:lo + (1 << 18)].double()
                  - V0[lo:lo + (1 << 18)].T.double())
            acc += (dv * dv).sum()
        kept["change_V"] = acc.sqrt()
        theta0, leaves = kept.pop("theta0"), kept.pop("leaves")
        for name, sl in leaves.items():
            kept[f"change_{name}"] = torch.linalg.vector_norm(
                d.theta[sl].double() - theta0[sl].double())


class _Trainer:
    """The model in fmbench/reference.py's ``steps``: its ``grads`` gives
    the margin and the slot gradients of each step and takes Adam's step
    on the dense weights (the table's update reads none of them); the
    updaters' settings are the model's. Its ``readings`` are the dense
    leaves' ``grad_`` and ``change_``; ``dirs``: :func:`directions`."""

    def __init__(self, m: Model, theta0, dirs, dtype, fault):
        self.m, self.dtype, self.fault = m, dtype, fault
        self.dirs = dirs
        self.theta0 = theta0.to(dtype)
        self.theta = self.theta0.clone()
        self.mom = torch.zeros_like(self.theta)
        self.vel = torch.zeros_like(self.theta)
        self.t = 0
        self.readings: dict[str, float] = {}

    def __getattr__(self, name):
        return getattr(self.m, name)

    def _forward(self, V, x, fields, theta):
        onehot = torch.nn.functional.one_hot(fields, self.m.F).to(V.dtype)
        e = torch.einsum("blf,bld->bfd", onehot, x[..., None] * V)
        return self.m.margins(e, theta)

    def grads(self, x, w, V, batch, d_of):
        """py, the slot gradients of w (zero) and V, by autograd in blocks
        of rows: the margins first, then each block's forward again with
        its rows' coefficient ``d``. The first step also reads ``grad_V``
        (:meth:`_first_nV`)."""
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.fault == "tf32"
        try:
            B = x.shape[0]
            fields = batch.fields
            blocks = [slice(a, min(a + BLOCK_ROWS, B))
                      for a in range(0, B, BLOCK_ROWS)]
            with torch.no_grad():
                py = torch.cat([self._forward(V[s], x[s], fields[s],
                                              self.theta) for s in blocks])
            d = d_of(py)
            gV = torch.empty_like(V)
            gt = torch.zeros_like(self.theta)
            for s in blocks:
                Vs = V[s].detach().requires_grad_(True)
                th = self.theta.detach().requires_grad_(True)
                out = self._forward(Vs, x[s], fields[s], th)
                a, b = torch.autograd.grad(out, (Vs, th), grad_outputs=d[s])
                gV[s] = a
                gt += b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
        if self.t == 0:
            self._first_nV(V, gV, batch.rows)
        self._adam(gt)
        return py, torch.zeros_like(x), gV

    def _first_nV(self, V, gV, rows):
        """``grad_V`` after the first step: AdaGrad's ``nV`` then, each
        touched row's ``(g + V_l2 V)^2`` where the row passed the gate with
        a count of 0 (``V_threshold <= 0``), as fmbench/reference.py's
        ``steps`` updates it; 0 for an unchanged state."""
        m, K = self.m, V.shape[-1]
        if self.fault == "frozen" or m.V_threshold > 0:
            self.readings["grad_V"] = 0.0
            return
        flat = rows.reshape(-1)
        R = int(flat.max()) + 1
        g = torch.zeros((R, K), dtype=V.dtype, device=V.device).index_add_(
            0, flat, gV.reshape(-1, K))
        v = torch.zeros_like(g).index_copy_(0, flat, V.reshape(-1, K))
        touched = torch.zeros(R, dtype=torch.bool, device=V.device)
        touched[flat] = True
        gr = (g + m.V_l2 * v)[touched].double()
        self.readings["grad_V"] = float((gr * gr).sum().sqrt())

    def _adam(self, g):
        m = self.m
        self.t += 1
        if self.fault != "frozen":
            self.mom = m.beta1 * self.mom + (1 - m.beta1) * g
            self.vel = m.beta2 * self.vel + (1 - m.beta2) * g * g
            lr_t = m.dense_lr_eta * math.sqrt(1 - m.beta2 ** self.t) / (
                1 - m.beta1 ** self.t)
            self.theta = self.theta - lr_t * self.mom / (self.vel.sqrt()
                                                         + m.eps)
        leaves = m.leaves()
        if self.t == 1:
            for name, sl in leaves.items():
                self.readings[f"grad_{name}"] = float(grad_reading(
                    self.vel[sl], self.mom[sl], self.dirs[sl]))
        if self.t == plain.CHECKED_STEPS:
            for name, sl in leaves.items():
                self.readings[f"change_{name}"] = float(
                    torch.linalg.vector_norm(self.theta[sl].double()
                                             - self.theta0[sl].double()))


def reference(seed: int, first: traffic.Rows, m: Model, device,
              dtype=torch.float64, fault: str | None = None) -> dict:
    """The reference's readings of the first steps, from the state
    ``place`` wrote (worked out again from the seed), in ``dtype``;
    ``fault``: fmbench/reference.py's ``frozen`` (the dense weights left
    unchanged too) and ``half_batch``, or ``tf32`` (float32 products in
    TF32, for the precision control; TF32 is off otherwise)."""
    held, batches = plain.reference_batches(first, m.num_bits, device)
    V0 = plain.initial_factors(seed, 1 << m.num_bits, m.K, m.init_scale,
                               device)
    V0h = V0[held]
    del V0
    tr = _Trainer(m, initial_dense(seed, m, device),
                  directions(seed, m, device), dtype, fault)
    out = plain.steps(batches, V0h, tr, dtype=dtype, fault=fault)
    out.pop("grad_w")
    out.update(tr.readings)
    return out


# -- counts ------------------------------------------------------------------


def shape(b: traffic.Rows, m: Model) -> dict:
    """One replayed batch's shape for the counts."""
    return dict(B=b.batch_size, L=b.ids.shape[1],
                n=traffic.distinct_rows(b, m.num_bits)[0], K=m.K, F=m.F,
                H=m.heads, dh=m.head_dim, layers=len(ATTN), P=m.size)


def _layer_ops(s: dict, d_in: int) -> tuple[int, int]:
    """A row's (matrix-product multiply-adds, other operations) through
    one interacting layer, forward: the projections, each head's scores
    and weighted sum; the softmax (max, exp, sum, divide) and the
    residual's add and ReLU."""
    F, H, dh = s["F"], s["H"], s["dh"]
    w = H * dh
    mac = F * d_in * 4 * w + 2 * H * F * F * dh
    other = 4 * H * F * F + 2 * F * w
    return mac, other


def attention_flops(s: dict) -> int:
    """The stack and the output, forward and backward, for the batch:
    each multiply-add is 2 operations, and the backward's products are
    twice the forward's (the input's and the weight's gradient; for
    attention dA, dV, dQ, dK); its softmax and ReLU about as many other
    operations as the forward's."""
    w = s["H"] * s["dh"]
    mac = other = 0
    for l in range(s["layers"]):
        a, b = _layer_ops(s, s["K"] if l == 0 else w)
        mac, other = mac + a, other + b
    mac += s["F"] * w                                   # the output
    return s["B"] * (3 * 2 * mac + 2 * other)


def attention_bytes(s: dict) -> int:
    """The least traffic of the stack: the field embeddings in and their
    gradient out, the margin and its coefficient, the dense weights read
    and their gradient written."""
    return counts.F * (2 * s["B"] * s["F"] * s["K"] + 2 * s["B"]
                       + 2 * s["P"])


def step_bytes(s: dict) -> int:
    """The sparse step's least traffic (fmbench/counts.py, with fields)
    and the dense part's: the weights, Adam's two moments and the
    gradient read, the weights and moments written."""
    return (counts.step_bytes(s["B"], s["L"], s["n"], s["K"], True)
            + counts.F * 7 * s["P"])


def step_flops(s: dict) -> int:
    """The stack's, each slot's x V into its field and its gradient row
    (2 + K), the table's updaters and Adam (about 10 a weight)."""
    return (attention_flops(s) + s["B"] * s["L"] * 2 * (1 + s["K"])
            + counts.update_flops(s["n"], s["K"]) + 10 * s["P"])


# FM's B1 and B2; B3 on the 1 + K rows of each slot's gradient, as FFM's.
# No reader lists this cell yet: kernel_roofline.train, which reads
# KERNELS, lists the three older cells (PERF.md §7)
KERNELS = dict(fm.KERNELS, segsum=(
    ("segsum_tiles_kernel", "segsum_cross"),
    lambda s: counts.segsum_bytes(s["B"] * s["L"], s["n"], 1 + s["K"])))
