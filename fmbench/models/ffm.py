"""The field-aware factorization machine (``loss=ffm``): FM's table, state,
readings and reference (fmbench/models/fm.py), with ``K = F k`` factors a
row, ``k`` for each of ``F`` fields, and its own margin and counts."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fmbench import counts, traffic
from fmbench import reference as plain
from fmbench.models import fm

LEAVES, keep, place, reference = fm.LEAVES, fm.keep, fm.place, fm.reference


@dataclass
class Model(plain.Table):
    F: int = 0      # fields (the slot is the field when num_fields = 0)

    @classmethod
    def of(cls, conf: dict) -> "Model":
        F = conf.get("num_fields", 0) or conf["max_nnz_per_row"]
        return cls(num_bits=int(conf["num_bits"]), K=int(conf["V_dim"]) * F,
                   init_scale=float(conf["V_init_scale"]), F=F,
                   **plain.Table.updaters(conf))

    def grads(self, x, w, V, batch, d_of):
        """FFM margin ``py = sum_i x_i w_i + sum_{i<j} x_i x_j <V_i[f_j],
        V_j[f_i]>`` and its slot gradients. ``V`` is [B, L, F*k]: slot i's
        factors for each field."""
        B, L, K = V.shape
        F = self.F
        k = K // F
        V4 = V.reshape(B, L, F, k)
        f = batch.fields if batch.fields is not None else torch.arange(
            L, device=V.device).expand(B, L)
        # A[b, i, j] = V_i[f_j];  At[b, i, j] = V_j[f_i]
        A = torch.gather(V4, 2, f[:, None, :, None].expand(B, L, L, k))
        At = A.transpose(1, 2)
        off = ~torch.eye(L, dtype=torch.bool, device=V.device)
        M = x[:, :, None] * x[:, None, :] * off                 # [B, L, L]
        py = (x * w).sum(dim=1) + 0.5 * (M * (A * At).sum(dim=3)).sum(
            dim=(1, 2))
        d = d_of(py)
        G = (d[:, None, None] * M)[..., None] * At              # [B, i, j, k]
        gV4 = torch.zeros((B, L, F, k), dtype=V.dtype, device=V.device)
        gV4.scatter_add_(2, f[:, None, :, None].expand(B, L, L, k), G)
        return py, d[:, None] * x, gV4.reshape(B, L, K)



def shape(b: traffic.Rows, m: Model) -> dict:
    """One replayed batch's shape for the counts."""
    return dict(B=b.batch_size, L=b.ids.shape[1],
                n=traffic.distinct_rows(b, m.num_bits)[0], K=m.K, F=m.F,
                fields=b.fields is not None)


def step_bytes(s: dict) -> int:
    return counts.step_bytes(s["B"], s["L"], s["n"], s["K"], s["fields"])


def step_flops(s: dict) -> int:
    """Per ordered slot pair: x_i x_j, the k-dot of V_i[f_j] and V_j[f_i]
    and its weighting (2k + 2), the backward's k products and the field
    sum (3k); per slot its gradient rows; the updates."""
    B, L, K = s["B"], s["L"], s["K"]
    k = K // s["F"]
    return (B * L * (L - 1) * (5 * k + 2) + B * L * (2 + K) + B * 10
            + counts.update_flops(s["n"], K))


# FM's B1 and B2; B3 on FFM's payload, each slot's gradient row (1 + K),
# in place of FM's fused sums
KERNELS = dict(fm.KERNELS, segsum=(
    ("segsum_tiles_kernel", "segsum_cross"),
    lambda s: counts.segsum_bytes(s["B"] * s["L"], s["n"], 1 + s["K"])))
