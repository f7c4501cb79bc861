"""The plain reference's shared part: the first training steps of a model
over a hashed table, written from the equations in plain PyTorch, in any
dtype. Each model's margin and slot gradients are its module's
(``fmbench/models/<model>.py``, ``Model.grads``); the rest is here.

It imports nothing of the program. It takes the rows the benchmark made
(raw ids, labels, libffm fields), hashes the ids into table rows as the
configuration's ``num_bits`` states (the splitmix64 finaliser, then the low
bits), and trains from the benchmark's initial table: ``w = z = n = cnt = 0``,
``nV = 0`` and ``V = V0``. Only the rows the steps touch are held.

A step, for one batch of rows ``b`` with slots ``(b, i)``:

* pull: ``w[r]`` and ``V[r]``, where ``V[r]`` reads 0 until the row's count
  before the step is at least ``V_threshold``;
* margin ``py`` and its slot gradients: the model's ``grads``;
* loss ``log(1 + exp(-y py))`` with ``y = 2 label - 1``, summed over the
  batch; its derivative ``d = sigmoid(py) - label``; gradients are sums
  over the batch;
* per-row sums of the slot gradients ``d dpy/dw_i`` and ``d dpy/dV_i``;
* FTRL-proximal on ``w`` of every row the batch touches:
  ``n' = n + g^2``, ``z' = z + g - (sqrt(n') - sqrt(n)) / lr_eta * w``,
  ``w' = 0`` if ``|z'| <= l1``, else
  ``-(z' - sign(z') l1) / ((lr_beta + sqrt(n')) / lr_eta + l2)``;
  ``cnt += occurrences``;
* AdaGrad on ``V`` of the touched rows whose count before the step passed
  the gate: ``g' = g + V_l2 V``, ``nV' = nV + g'^2``,
  ``V' = V - V_lr_eta g' / (sqrt(nV') + V_lr_beta)``.

:func:`steps` returns what :mod:`fmbench.check` compares: each step's loss,
the gradient norms the optimizer state holds after the first steps, and the
norms of the parameters' change after the last.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import traffic

# the program's first steps of epoch 0 that the check compares
CHECKED_STEPS = 3


def hash_rows(raw: np.ndarray, num_bits: int) -> np.ndarray:
    """Table rows (i64) of raw u64 feature ids: the splitmix64 finaliser,
    then the low ``num_bits`` bits."""
    z = np.array(raw, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z += np.uint64(0x9E3779B97F4A7C15)
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
    return (z & np.uint64((1 << num_bits) - 1)).astype(np.int64)


UPDATER_KEYS = ("lr_eta", "lr_beta", "l1", "l2", "V_lr_eta", "V_lr_beta",
                "V_l2", "V_threshold")


@dataclass
class Table:
    """What :func:`steps` reads of a model: a table of ``2**num_bits`` rows
    of ``w`` and ``K`` factors, FTRL on w and count-gated AdaGrad on V
    without a tail filter. A model's module (``fmbench/models/``) subclasses
    it with its ``of`` (every key stated in the configuration file's
    ``conf``, none taken from the program's defaults) and its ``grads``."""

    num_bits: int
    K: int
    init_scale: float
    lr_eta: float
    lr_beta: float
    l1: float
    l2: float
    V_lr_eta: float
    V_lr_beta: float
    V_l2: float
    V_threshold: float

    @staticmethod
    def updaters(conf: dict) -> dict:
        """The updaters' keys of ``conf``, once it states the updaters the
        reference implements."""
        if (conf["w_updater"], conf["V_updater"],
                conf.get("tail_feature_filter", 0)) != ("ftrl", "adagrad", 0):
            raise ValueError("the reference implements FTRL on w and AdaGrad "
                             "on V without a tail filter")
        return {key: float(conf[key]) for key in UPDATER_KEYS}

    def grads(self, x, w, V, batch: "Batch", d_of):
        """The margin ``py`` [B] and the slot gradients of w [B, L] and V
        [B, L, K], given ``d_of(py)``, the loss's derivative."""
        raise NotImplementedError


def initial_factors(seed: int, rows: int, k: int, scale: float,
                    device) -> torch.Tensor:
    """The benchmark's initial V [rows, k], uniform in (-scale, scale),
    from its own generator (one the traffic does not draw from)."""
    g = traffic.generator(seed ^ 0x5DEECE66D, device)
    v = torch.rand((rows, k), generator=g, device=device)
    return v.mul_(2.0).sub_(1.0).mul_(scale)


@dataclass
class Batch:
    """One batch for the reference: ``rows`` i64 [B, L] indices into the
    held rows, ``labels`` [B], ``fields`` i64 [B, L] or None (the slot is
    the field). Every value is 1."""

    rows: torch.Tensor
    labels: torch.Tensor
    fields: torch.Tensor | None


def reference_batches(first: traffic.Rows, num_bits: int, device):
    """The first batches for the reference, and the table rows they hold
    (ids hashed on the host as the configuration's ``num_bits`` says)."""
    raw = first.ids.cpu().numpy().astype(np.uint64)
    held, idx = torch.unique(torch.as_tensor(
        hash_rows(raw, num_bits), device=device), return_inverse=True)
    out = []
    for i in range(first.num_batches):
        s = slice(i * first.batch_size, (i + 1) * first.batch_size)
        out.append(Batch(
            rows=idx[s], labels=first.labels[s].to(device),
            fields=(None if first.fields is None
                    else first.fields[s].to(device).long())))
    return held, out


def stable_logloss(m: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-torch.abs(m))) + torch.clamp(m, min=0.0)


def steps(batches: list[Batch], V0: torch.Tensor, h: Table,
          dtype=torch.float64, fault: str | None = None) -> dict:
    """Train from the initial table over ``batches``, in ``dtype``. ``V0``
    [R, K] holds the initial factors of the held rows. ``fault`` plants a
    fault for the comparison's own checks: ``frozen`` (no step changes the
    table), ``half_batch`` (the second half of every batch left out and the
    first half weighted 2, the mean over the rest). Returns per-step losses
    and, from the table, ``grad_w`` (sqrt of the summed FTRL ``n`` after
    step 1), ``grad_V`` (sqrt of the summed AdaGrad ``nV`` after step 2),
    ``change_w`` and ``change_V`` (the norms of the change after the last
    step), as floats."""
    dev = V0.device
    R, K = V0.shape
    V0 = V0.to(dtype)
    V = V0.clone()
    nV = torch.zeros_like(V)
    w, z, n, cnt = (torch.zeros(R, dtype=dtype, device=dev)
                    for _ in range(4))
    out = {"loss": []}
    for t, b in enumerate(batches):
        B, L = b.rows.shape
        x = torch.ones((B, L), dtype=dtype, device=dev)
        lab = b.labels.to(dtype)
        mask = torch.ones(B, dtype=dtype, device=dev)
        if fault == "half_batch":
            mask[B // 2:] = 0.0
            mask[:B // 2] = 2.0
        y = 2.0 * lab - 1.0
        gate = (cnt >= h.V_threshold).to(dtype)
        Vb = (V * gate[:, None])[b.rows]

        def d_of(py):
            return (torch.sigmoid(py) - lab) * mask

        py, gw, gV = h.grads(x, w[b.rows], Vb, b, d_of)
        out["loss"].append(float((stable_logloss(-y * py) * mask).sum()))
        flat = b.rows.reshape(-1)
        g = torch.zeros(R, dtype=dtype, device=dev).index_add_(
            0, flat, gw.reshape(-1))
        gv = torch.zeros((R, K), dtype=dtype, device=dev).index_add_(
            0, flat, gV.reshape(-1, K))
        occ = torch.zeros(R, dtype=dtype, device=dev).index_add_(
            0, flat, torch.ones_like(flat, dtype=dtype))
        if fault != "frozen":
            hit = occ > 0
            n_new = n + g * g
            sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / h.lr_eta
            z_new = z + g - sigma * w
            w_new = torch.where(
                torch.abs(z_new) <= h.l1, torch.zeros_like(z_new),
                -(z_new - torch.sign(z_new) * h.l1)
                / ((h.lr_beta + torch.sqrt(n_new)) / h.lr_eta + h.l2))
            w = torch.where(hit, w_new, w)
            z = torch.where(hit, z_new, z)
            n = torch.where(hit, n_new, n)
            act = (hit & (gate > 0))[:, None]
            gr = gv + h.V_l2 * V
            nv_new = nV + gr * gr
            v_new = V - h.V_lr_eta * gr / (torch.sqrt(nv_new) + h.V_lr_beta)
            V = torch.where(act, v_new, V)
            nV = torch.where(act, nv_new, nV)
            cnt = cnt + occ
        if t == 0:
            out["grad_w"] = float(torch.sqrt(n.double().sum()))
        if t == 1:
            out["grad_V"] = float(torch.sqrt(nV.double().sum()))
    out["change_w"] = float(torch.linalg.vector_norm(w.double()))
    out["change_V"] = float(torch.linalg.vector_norm(
        V.double() - V0.double()))
    return out
