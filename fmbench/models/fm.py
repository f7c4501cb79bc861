"""The factorization machine (``loss=fm``): a hashed table of ``w`` and ``K``
factors a row, FTRL on w and count-gated AdaGrad on V.

What the harness asks of a model's module (PERF.md §4):

* ``Model.of(conf)``: what the reference reads of the configuration;
* ``place(learner, seed, device, model)``: the benchmark's initial table,
  written into the program; returns ``kept``, what ``keep`` needs;
* ``keep(kept, state, metrics, call)``: the program's readings after each
  of the first ``CHECKED_STEPS`` calls of its step, into ``kept`` as
  device tensors (a list of floats, or one), which afterwards holds them
  alone;
* ``reference(seed, first, model, device, dtype, fault)``: the plain
  reference's readings of the same steps, under the same keys, from the
  initial table worked out again from the seed;
* ``LEAVES``: the leaves fmbench/check.py's ``grad`` and ``change`` go over;
* the counts: ``shape(batch, model)``, ``step_bytes(shape)``,
  ``step_flops(shape)`` and ``KERNELS`` (a kernel kind -> its names in
  the trace and its useful bytes of a shape).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fmbench import counts, traffic
from fmbench import reference as plain

LEAVES = ("w", "V")


@dataclass
class Model(plain.Table):
    @classmethod
    def of(cls, conf: dict) -> "Model":
        return cls(num_bits=int(conf["num_bits"]), K=int(conf["V_dim"]),
                   init_scale=float(conf["V_init_scale"]),
                   **plain.Table.updaters(conf))

    def grads(self, x, w, V, batch, d_of):
        """FM margin ``py = sum_i x_i w_i + 1/2 sum_k ((sum_i x_i V_ik)^2 -
        sum_i x_i^2 V_ik^2)`` and its slot gradients."""
        xv = x[..., None] * V                                   # [B, L, K]
        s = xv.sum(dim=1)                                       # [B, K]
        py = (x * w).sum(dim=1) + 0.5 * (s * s - (xv * xv).sum(dim=1)).sum(
            dim=1)
        d = d_of(py)
        gw = d[:, None] * x
        gV = (d[:, None] * x)[..., None] * (s[:, None, :] - xv)
        return py, gw, gV


def place(learner, seed: int, device, m: Model) -> dict:
    """``w = z = n = cnt = nV = 0`` and ``V = V0``, uniform in
    (-init_scale, init_scale) from the seed (fmbench/reference.py
    ``initial_factors``)."""
    V0 = plain.initial_factors(seed, learner.store.num_rows, m.K,
                               m.init_scale, device)
    st = learner.state
    for leaf in ("w", "z", "n", "cnt", "nV"):
        getattr(st, leaf).zero_()
    st.V.copy_(V0.T)
    return {"loss": [], "V0": V0}


def keep(kept: dict, state, metrics, call: int) -> None:
    """Each step's summed logloss; FTRL's ``sqrt(sum n)`` after step 1 and
    AdaGrad's ``sqrt(sum nV)`` after step 2 (V's rows pass the count gate
    in the second step at the earliest); ``|w|`` and ``|V - V0|`` after
    the last."""
    kept["loss"].append(metrics.logloss_sum.double())
    if call == 1:
        kept["grad_w"] = state.n.double().sum().sqrt()
    if call == 2:
        kept["grad_V"] = state.nV.double().sum().sqrt()
    if call == plain.CHECKED_STEPS:
        kept["change_w"] = torch.linalg.vector_norm(state.w.double())
        V0 = kept.pop("V0")
        acc = torch.zeros((), dtype=torch.float64, device=state.w.device)
        V = state.V
        for lo in range(0, V0.shape[0], 1 << 18):
            d = (V[:, lo:lo + (1 << 18)].double()
                 - V0[lo:lo + (1 << 18)].T.double())
            acc += (d * d).sum()
        kept["change_V"] = acc.sqrt()


def reference(seed: int, first: traffic.Rows, m: Model, device,
              dtype=torch.float64, fault: str | None = None) -> dict:
    """The reference's readings of the first steps: the same rows, the same
    initial table (worked out again from the seed), in ``dtype``, with
    ``fault`` planted (fmbench/reference.py ``steps``)."""
    held, batches = plain.reference_batches(first, m.num_bits, device)
    V0 = plain.initial_factors(seed, 1 << m.num_bits, m.K, m.init_scale,
                               device)
    V0h = V0[held]
    del V0
    return plain.steps(batches, V0h, m, dtype=dtype, fault=fault)


def shape(b: traffic.Rows, m: Model) -> dict:
    """One replayed batch's shape for the counts."""
    return dict(B=b.batch_size, L=b.ids.shape[1],
                n=traffic.distinct_rows(b, m.num_bits)[0], K=m.K)


def step_bytes(s: dict) -> int:
    return counts.step_bytes(s["B"], s["L"], s["n"], s["K"], False)


def step_flops(s: dict) -> int:
    """Per slot and factor: x V, the square, two sums, the backward
    x (S - x V) d (4), its per-row sum; the updates."""
    S = s["B"] * s["L"]
    return (S * (9 * s["K"] + 4) + s["B"] * (3 * s["K"] + 10)
            + counts.update_flops(s["n"], s["K"]))


KERNELS = {
    "pull": (("rowmajor_pull_kernel",),
             lambda s: counts.pull_bytes(s["n"], s["K"])),
    "segsum": (("fm_keysum_kernel", "fm_keysum_join"),
               lambda s: counts.fm_keysum_bytes(s["B"] * s["L"], s["B"],
                                                s["n"], s["K"])),
    "apply": (("rowmajor_apply_kernel",),
              lambda s: counts.apply_bytes(s["n"], s["K"])),
}
