"""Whole-table sweep kernels (B4, B5) and the per-row table math they share
with the pair kernels.

Port of ``difacto_tpu/ops/sweep_ms.py``: ``sweep_pull_ms`` and
``sweep_apply_ms``, the kernels behind ``kernel=pallas`` (ops/sweep.py
wraps them with one sorted stream), and ``fused_table_update``, the
per-row optimizer math that the apply kernels (csrc/apply_pairs.cu,
csrc/sweep_apply.cu) repeat and the plain versions call.

The slot ids ``sid [NNZ]`` are S streams laid end to end, each sorted;
``offsets [S, N/R + 1]`` holds each stream's searchsorted boundaries of
the table blocks of R = ``block_rows`` rows. A slot takes part when it
lies in the slice ``[offsets[s, i], offsets[s, i+1])`` of its own id's
block ``i`` in some stream ``s``; other slots (the sentinel ``N``)
contribute nothing, as in the TPU kernels (``sweep_ms.py:62-65``).

The TPU kernels stream each whole table block through VMEM and address
the slots with one-hot matmuls over 1024-aligned windows, because Mosaic
cannot address single rows (``sweep_ms.py:12-31``). The Hopper kernels
come in two designs, one per table layout, as the pair kernels do:

* a planar :class:`FMState` goes to csrc/sweep_pull.cu and
  csrc/sweep_apply.cu, which scan the table one thread per row, list the
  rows some slot names, and spread those rows' leaves over the block's
  threads;
* a row-major :class:`PackedFMState` (``layout=packed``) goes to
  csrc/rowmajor_sweep.cu, which deals the work by slots (a slot owns its
  row when it is the row's first slot in the first stream that names it)
  and moves a row's 16 + 8K contiguous bytes in 16-byte pieces. The two
  give the same bits.

In both, rows no slot names are not read. See the sources' notes.

Each of ``sweep_pull_ms`` and ``sweep_apply_ms`` is a wrapper: a CUDA
tensor launches the kernel (or raises on what the kernel does not take);
a CPU tensor takes the plain PyTorch version beside it, which runs on
either layout through the packed state's column views. There is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..config import FMParam
from ..updaters.updater import (FMState, PackedFMState, adagrad_v,
                                adagrad_w, ftrl_w, sgd_v, sgd_w)
from . import cuda

W_UPDATERS = {"ftrl": 0, "adagrad": 1, "sgd": 2}
V_UPDATERS = {"adagrad": 0, "sgd": 1}


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


def gather_rows(state: FMState, ids: torch.Tensor, keep: torch.Tensor,
                param: FMParam) -> torch.Tensor:
    """Planar rows [1+K, L] at table rows ``ids`` where ``keep``, 0
    elsewhere: row 0 is w, rows 1..K are V gated by ``cnt >=
    V_threshold``. The plain version of both pull kernels."""
    k = state.k
    idx = torch.where(keep, ids, 0).long()
    out = torch.empty((1 + k, ids.shape[0]), dtype=torch.float32,
                      device=ids.device)
    out[0] = torch.where(keep, state.w[idx], 0.0)
    if k > 0:
        act = keep & (state.cnt[idx] >= float(param.V_threshold))
        out[1:] = torch.where(act[None, :], state.V[:, idx], 0.0)
    return out


def apply_payload(grads: torch.Tensor, add_cnt: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The apply payload ``[3+K, U]`` gw | gV | add_cnt | touch from
    planar per-key gradients ``[1+K, U]``, zero on invalid lanes."""
    vf = valid.to(torch.float32)
    return torch.cat([
        torch.where(valid[None, :], grads, 0.0),  # gw | gV planar
        (add_cnt * vf)[None, :],                  # add_cnt
        vf[None, :],                              # touch
    ], dim=0)


# ---------------------------------------------------------------------------
# slot coverage and argument checks
# ---------------------------------------------------------------------------


def _check_blocks(n: int, block_rows: int, offsets: torch.Tensor) -> int:
    if block_rows <= 0 or n % block_rows != 0:
        raise ValueError(f"the table's {n} rows are not a multiple of "
                         f"block_rows {block_rows}")
    nb = n // block_rows
    if offsets.dim() != 2 or offsets.shape[1] != nb + 1:
        raise ValueError(f"offsets has shape {tuple(offsets.shape)}, "
                         f"expected [S, {nb + 1}]")
    return nb


def _in_slices(sid: torch.Tensor, offsets: torch.Tensor, n: int,
               block_rows: int) -> torch.Tensor:
    """Mask [S, NNZ]: slot j lies in stream s's slice of its id's block."""
    real = (sid >= 0) & (sid < n)
    blk = torch.where(real, sid, 0).long() // block_rows
    pos = torch.arange(sid.shape[0], device=sid.device)
    off = offsets.long()
    return real[None, :] & (off[:, blk] <= pos) & (pos < off[:, blk + 1])


# ---------------------------------------------------------------------------
# B4 pull: per-slot rows [1+K, NNZ]
# ---------------------------------------------------------------------------


def sweep_pull_ms_plain(state, sid: torch.Tensor,
                        offsets: torch.Tensor, param: FMParam, *,
                        block_rows: int = 1024) -> torch.Tensor:
    """The gated gather at the covered slots: the plain version of both
    sweep pull kernels. It reads the leaves by name, and a PackedFMState's
    leaves are views of its table's columns, so it runs on either layout."""
    n = state.num_rows
    _check_blocks(n, block_rows, offsets)
    covered = _in_slices(sid, offsets, n, block_rows).any(0)
    return gather_rows(state, sid, covered, param)


def _sweep_pull_rowmajor(state: PackedFMState, sid: torch.Tensor,
                         offsets: torch.Tensor, param: FMParam,
                         block_rows: int, vec: int = 0) -> torch.Tensor:
    """Launch the row-major sweep pull. ``vec`` caps the kernel's piece
    width (1, 2 or 4 floats; 0 = the widest the row layout allows), for
    the tests of the narrower paths."""
    n, k, nnz = state.num_rows, state.k, sid.shape[0]
    nb = _check_blocks(n, block_rows, offsets)
    dev = state.device
    cuda.require(state.tbl, "tbl", torch.float32, (n, 4 + 2 * k), dev)
    cuda.require(sid, "sid", torch.int32, (nnz,), dev)
    cuda.require(offsets, "offsets", torch.int32, None, dev)
    out = torch.empty((1 + k, nnz), dtype=torch.float32, device=dev)
    rc = cuda.library().dft_sweep_pull_rowmajor(
        state.tbl.data_ptr(), sid.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), n, k, nnz, offsets.shape[0], nb, block_rows,
        float(param.V_threshold), vec, cuda.stream(dev),
    )
    cuda.check(rc, "sweep_pull_rowmajor")
    cuda.LAUNCHES["sweep_pull_rowmajor"] += 1
    return out


def sweep_pull_ms(state, sid: torch.Tensor, offsets: torch.Tensor,
                  param: FMParam, *, block_rows: int = 1024) -> torch.Tensor:
    """Per-slot rows [1+K, NNZ] (planar) for ``sid`` (i32 [NNZ], S
    streams, each sorted; sentinel ``N``) and ``offsets`` (i32 [S,
    N/block_rows + 1]): row 0 is w, rows 1..K are V gated by ``cnt >=
    V_threshold``. Slots no slice covers are 0 (undefined in the TPU
    kernel). ``state`` is an FMState or a PackedFMState; the two layouts'
    kernels give the same output. They trap on a stream that is not
    sorted."""
    if sid.device.type == "cpu":
        return sweep_pull_ms_plain(state, sid, offsets, param,
                                   block_rows=block_rows)
    if isinstance(state, PackedFMState):
        return _sweep_pull_rowmajor(state, sid, offsets, param, block_rows)
    n, k, nnz = state.num_rows, state.k, sid.shape[0]
    nb = _check_blocks(n, block_rows, offsets)
    dev = state.device
    for name in ("w", "cnt"):
        cuda.require(getattr(state, name), name, torch.float32, (n,), dev)
    cuda.require(state.V, "V", torch.float32, (k, n), dev)
    cuda.require(sid, "sid", torch.int32, (nnz,), dev)
    cuda.require(offsets, "offsets", torch.int32, None, dev)
    out = torch.empty((1 + k, nnz), dtype=torch.float32, device=dev)
    rc = cuda.library().dft_sweep_pull(
        state.w.data_ptr(), state.cnt.data_ptr(), state.V.data_ptr(),
        sid.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, k, nnz,
        offsets.shape[0], nb, block_rows, float(param.V_threshold),
        cuda.stream(dev),
    )
    cuda.check(rc, "sweep_pull")
    cuda.LAUNCHES["sweep_pull"] += 1
    return out


# ---------------------------------------------------------------------------
# B5 apply: per-slot payload streams -> fused update of every named row
# ---------------------------------------------------------------------------


def sweep_apply_ms_plain(state, sid: torch.Tensor,
                         payload: torch.Tensor, offsets: torch.Tensor,
                         param: FMParam, *, block_rows: int = 1024):
    """A whole-table sweep: every covered slot's payload is added into a
    ``[3+K, N]`` accumulator, stream by stream in slot order, then
    ``fused_table_update`` runs over all rows — in place on ``state``, of
    either layout (a PackedFMState's leaves are views of its table, so the
    copies below write the table's columns)."""
    n, k = state.num_rows, state.k
    _check_blocks(n, block_rows, offsets)
    mask = _in_slices(sid, offsets, n, block_rows)
    acc = torch.zeros((3 + k, n), dtype=torch.float32, device=payload.device)
    for m in mask:
        acc.index_add_(1, sid[m].long(), payload[:, m])
    v, nv = (state.V, state.nV) if k > 0 else (None, None)
    w_o, z_o, n_o, cnt_o, v_o, nv_o = fused_table_update(
        acc, state.w, state.z, state.n, state.cnt, v, nv, param, k)
    for name, t in (("w", w_o), ("z", z_o), ("n", n_o), ("cnt", cnt_o),
                    ("V", v_o), ("nV", nv_o)):
        if t is not None:
            getattr(state, name).copy_(t)
    return state


def updater_args(p: FMParam) -> tuple:
    """The optimizer settings in the order the apply entries take them."""
    return (p.lr_eta, p.lr_beta, p.l1, p.l2, p.V_lr_eta, p.V_lr_beta, p.V_l2,
            float(p.V_threshold), int(p.tail_feature_filter),
            W_UPDATERS[p.w_updater], V_UPDATERS[p.V_updater])


def _sweep_apply_rowmajor(state: PackedFMState, sid: torch.Tensor,
                          payload: torch.Tensor, offsets: torch.Tensor,
                          param: FMParam, block_rows: int,
                          vec: int = 0) -> PackedFMState:
    """Launch the row-major sweep apply (``vec`` as in
    :func:`_sweep_pull_rowmajor`). The kernel checks the streams' order
    itself, on the ids it reads anyway."""
    n, k, nnz = state.num_rows, state.k, sid.shape[0]
    nb = _check_blocks(n, block_rows, offsets)
    dev = state.device
    cuda.require(state.tbl, "tbl", torch.float32, (n, 4 + 2 * k), dev)
    cuda.require(sid, "sid", torch.int32, (nnz,), dev)
    cuda.require(payload, "payload", torch.float32, (3 + k, nnz), dev)
    cuda.require(offsets, "offsets", torch.int32, None, dev)
    rc = cuda.library().dft_sweep_apply_rowmajor(
        state.tbl.data_ptr(), sid.data_ptr(), payload.data_ptr(),
        offsets.data_ptr(), n, k, nnz, offsets.shape[0], nb, block_rows,
        *updater_args(param), vec, cuda.stream(dev),
    )
    cuda.check(rc, "sweep_apply_rowmajor")
    cuda.LAUNCHES["sweep_apply_rowmajor"] += 1
    return state


def sweep_apply_ms(state, sid: torch.Tensor, payload: torch.Tensor,
                   offsets: torch.Tensor, param: FMParam, *,
                   block_rows: int = 1024):
    """Update ``state`` (FMState or PackedFMState) IN PLACE from the
    planar per-slot payload ``[3+K, NNZ]`` (gw | gV | add_cnt | touch)
    over ``sid``/``offsets`` (as :func:`sweep_pull_ms`): every covered slot
    adds into its row, duplicates included, then per row the w updater
    (tail filter applied) and the V updater gated by the pre-update count
    where the summed touch is > 0, and ``cnt += add_cnt``. In place
    replaces the TPU kernel's ``input_output_aliases``; returns ``state``
    for chaining. The two layouts' kernels give the same bits; both trap
    on a stream that is not sorted."""
    if sid.device.type == "cpu":
        return sweep_apply_ms_plain(state, sid, payload, offsets, param,
                                    block_rows=block_rows)
    if isinstance(state, PackedFMState):
        return _sweep_apply_rowmajor(state, sid, payload, offsets, param,
                                     block_rows)
    n, k, nnz = state.num_rows, state.k, sid.shape[0]
    nb = _check_blocks(n, block_rows, offsets)
    dev = state.device
    for name in ("w", "z", "n", "cnt"):
        cuda.require(getattr(state, name), name, torch.float32, (n,), dev)
    for name in ("V", "nV"):
        cuda.require(getattr(state, name), name, torch.float32, (k, n), dev)
    cuda.require(sid, "sid", torch.int32, (nnz,), dev)
    cuda.require(payload, "payload", torch.float32, (3 + k, nnz), dev)
    cuda.require(offsets, "offsets", torch.int32, None, dev)
    rc = cuda.library().dft_sweep_apply(
        state.w.data_ptr(), state.z.data_ptr(), state.n.data_ptr(),
        state.cnt.data_ptr(), state.V.data_ptr(), state.nV.data_ptr(),
        sid.data_ptr(), payload.data_ptr(), offsets.data_ptr(), n, k, nnz,
        offsets.shape[0], nb, block_rows, *updater_args(param),
        cuda.stream(dev),
    )
    cuda.check(rc, "sweep_apply")
    cuda.LAUNCHES["sweep_apply"] += 1
    return state
