"""The fused per-row table update (port of
``difacto_tpu/ops/sweep_ms.py::fused_table_update``).

It is the per-row math of the apply kernel (csrc/apply_pairs.cu) and the
core of that kernel's plain version (ops/pair_sweep.py). The whole-table
sweep kernels of the same JAX module (B4/B5, ``kernel=pallas``) wait for
ROADMAP A10.
"""

from __future__ import annotations

import torch

from ..config import FMParam
from ..updaters.updater import adagrad_v, adagrad_w, ftrl_w, sgd_v, sgd_w


def fused_table_update(acc, w, z, n, cnt, v, nv, p: FMParam, k: int):
    """The server-side optimizer on gathered rows. ``acc [3+K, R]``
    carries per-row aggregated payload rows gw | gV | add_cnt | touch;
    w/z/n/cnt are [R], v/nv [K, R] (None when K == 0). Returns the
    POST-masking values (rows not touched / not trainable keep their
    inputs), so callers can write them back verbatim. The masks read the
    PRE-update count."""
    g = acc[0]
    add_cnt = acc[1 + k]
    touch = acc[2 + k] > 0.0

    upd_w = touch
    if p.tail_feature_filter > 0:
        upd_w = upd_w & (cnt >= p.tail_feature_filter)

    if p.w_updater == "ftrl":
        w_new, z_new, n_new = ftrl_w(g, w, z, n, p)
    elif p.w_updater == "adagrad":
        w_new, n_new = adagrad_w(g, w, n, p)
        z_new = z
    else:  # sgd
        w_new, z_new, n_new = sgd_w(g, w, p), z, n

    w_o = torch.where(upd_w, w_new, w)
    z_o = torch.where(upd_w, z_new, z)
    n_o = torch.where(upd_w, n_new, n)
    cnt_o = cnt + add_cnt

    v_o = nv_o = None
    if k > 0:
        gv = acc[1 : 1 + k]
        active = touch & (cnt >= p.V_threshold)
        if p.tail_feature_filter > 0:
            active = active & (cnt >= p.tail_feature_filter)
        if p.V_updater == "adagrad":
            v_new, nv_new = adagrad_v(gv, v, nv, p)
        else:  # sgd
            v_new, nv_new = sgd_v(gv, v, p), nv
        mv = active[None, :]
        v_o = torch.where(mv, v_new, v)
        nv_o = torch.where(mv, nv_new, nv)
    return w_o, z_o, n_o, cnt_o, v_o, nv_o
