"""Table kernels of the train and eval steps: pull and apply.

Port of ``difacto_tpu/ops/pair_sweep.py::pull_pairs``, ``::apply_pairs``
and ``::apply_pairs2``. The TPU kernels walk host-built (table block,
128-lane unique window) pairs with one-hot matmuls, because Mosaic
addresses only aligned tiles (``pair_sweep.py:1-25``). The Hopper kernels
(csrc/pull_pairs.cu, csrc/apply_pairs.cu, csrc/planar_apply.cu) gather
and scatter rows directly, so they take no schedule: the same inputs map
to the same outputs.

``pull_pairs`` and ``apply_pairs`` take either table layout, as the JAX
updater's ``pull``/``update`` do: a planar :class:`FMState` goes to the
kernels above, a row-major :class:`PackedFMState` (``layout=packed``) to
the kernels of csrc/rowmajor_pairs.cu, designed for the card's 32-byte
sectors. One function, two layouts: the plain versions below run on
either through the packed state's column views. ``apply_pairs2`` is
planar only.

Each function is a wrapper: a CUDA tensor launches the kernel (or raises
on what the kernel does not take); a CPU tensor takes the plain PyTorch
version beside it. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..config import FMParam
from ..updaters.updater import FMState, PackedFMState, require_planar
from . import cuda
from .sweep_ms import updater_args, fused_table_update, gather_rows


# ---------------------------------------------------------------------------
# pull: rows [1+K, U] = per-unique-id rows (w | activated V), planar
# ---------------------------------------------------------------------------


def pull_pairs_plain(state, uids: torch.Tensor,
                     param: FMParam) -> torch.Tensor:
    """Indexing plus a mask: the plain version of both pull kernels
    (either layout)."""
    return gather_rows(state, uids, (uids >= 0) & (uids < state.num_rows),
                       param)


def _pull_rowmajor(state: PackedFMState, uids: torch.Tensor,
                   param: FMParam, vec: int = 0) -> torch.Tensor:
    """Launch the row-major pull. ``vec`` caps the kernel's piece width
    (1, 2 or 4 floats; 0 = the widest the row layout allows): the tests
    and the timing of the scalar path use it."""
    n, k, u = state.num_rows, state.k, uids.shape[0]
    dev = state.device
    cuda.require(state.tbl, "tbl", torch.float32, (n, 4 + 2 * k), dev)
    cuda.require(uids, "uids", torch.int32, (u,), dev)
    out = torch.empty((1 + k, u), dtype=torch.float32, device=dev)
    rc = cuda.library().dft_pull_rowmajor(
        state.tbl.data_ptr(), uids.data_ptr(), out.data_ptr(), n, k, u,
        float(param.V_threshold), vec, cuda.stream(dev),
    )
    cuda.check(rc, "pull_rowmajor")
    cuda.LAUNCHES["pull_rowmajor"] += 1
    return out


def pull_pairs(state, uids: torch.Tensor, param: FMParam) -> torch.Tensor:
    """Planar unique rows [1+K, U] for sorted unique ``uids`` (i32,
    sentinel ``N`` pads): row 0 is w, rows 1..K are V gated by
    ``cnt >= V_threshold``; sentinel lanes are 0. ``state`` is an FMState
    or a PackedFMState."""
    if uids.device.type == "cpu":
        return pull_pairs_plain(state, uids, param)
    if isinstance(state, PackedFMState):
        return _pull_rowmajor(state, uids, param)
    n, k, u = state.num_rows, state.k, uids.shape[0]
    dev = state.device
    for name in ("w", "cnt"):
        cuda.require(getattr(state, name), name, torch.float32, (n,), dev)
    cuda.require(state.V, "V", torch.float32, (k, n), dev)
    cuda.require(uids, "uids", torch.int32, (u,), dev)
    out = torch.empty((1 + k, u), dtype=torch.float32, device=dev)
    lib = cuda.library()
    rc = lib.dft_pull_pairs(
        state.w.data_ptr(), state.cnt.data_ptr(), state.V.data_ptr(),
        uids.data_ptr(), out.data_ptr(), n, k, u, float(param.V_threshold),
        cuda.stream(dev),
    )
    cuda.check(rc, "pull_pairs")
    cuda.LAUNCHES["pull_pairs"] += 1
    return out


# ---------------------------------------------------------------------------
# apply: per-key payload -> fused FTRL/AdaGrad/SGD on the touched rows
# ---------------------------------------------------------------------------


def apply_pairs_plain(state, uids: torch.Tensor, payload: torch.Tensor,
                      param: FMParam):
    """Gather, then ``fused_table_update``, then index write-back — in
    place on ``state`` (either layout). Equal ids in ``uids`` (which must
    be non-decreasing) sum their payload first, in lane order."""
    n, k = state.num_rows, state.k
    rid, inverse = torch.unique_consecutive(uids, return_inverse=True)
    acc = torch.zeros((payload.shape[0], rid.shape[0]), dtype=torch.float32,
                      device=payload.device)
    acc.index_add_(1, inverse, payload)
    keep = (rid >= 0) & (rid < n)
    rows = rid[keep].long()
    acc = acc[:, keep]
    v = state.V[:, rows] if k > 0 else None
    nv = state.nV[:, rows] if k > 0 else None
    w_o, z_o, n_o, cnt_o, v_o, nv_o = fused_table_update(
        acc, state.w[rows], state.z[rows], state.n[rows], state.cnt[rows],
        v, nv, param, k,
    )
    touched = acc[2 + k] > 0.0
    rt = rows[touched]
    state.w[rt] = w_o[touched]
    state.z[rt] = z_o[touched]
    state.n[rt] = n_o[touched]
    state.cnt[rt] = cnt_o[touched]
    if k > 0:
        state.V[:, rt] = v_o[:, touched]
        state.nV[:, rt] = nv_o[:, touched]
    return state


def _launch_apply(entry: str, state: FMState, uids: torch.Tensor,
                  payload: torch.Tensor, param: FMParam, *extra,
                  seg_len: int | None = None) -> FMState:
    """Check what the apply kernels take and launch the one named
    ``entry`` (``apply_pairs``, ``apply_pairs2`` or, over segments of
    ``seg_len`` lanes, ``apply_pairs_segs``: one contract), with ``extra``
    arguments before the stream."""
    n, k, u = state.num_rows, state.k, uids.shape[0]
    dev = state.device
    for name in ("w", "z", "n", "cnt"):
        cuda.require(getattr(state, name), name, torch.float32, (n,), dev)
    for name in ("V", "nV"):
        cuda.require(getattr(state, name), name, torch.float32, (k, n), dev)
    _check_stream(entry, uids, payload, k, dev, seg_len=seg_len)
    segs = () if seg_len is None else (seg_len,)
    rc = getattr(cuda.library(), "dft_" + entry)(
        state.w.data_ptr(), state.z.data_ptr(), state.n.data_ptr(),
        state.cnt.data_ptr(), state.V.data_ptr(), state.nV.data_ptr(),
        uids.data_ptr(), payload.data_ptr(), n, k, u, *segs,
        *updater_args(param), *extra, cuda.stream(dev),
    )
    cuda.check(rc, entry)
    cuda.LAUNCHES[entry] += 1
    return state


def _check_stream(entry: str, uids: torch.Tensor, payload: torch.Tensor,
                  k: int, dev: torch.device, order: bool = True,
                  seg_len: int | None = None) -> None:
    """What every apply kernel takes as its id stream and payload: one
    non-decreasing stream, or (``seg_len``) segments of ``seg_len`` lanes,
    each non-decreasing. ``order=False`` for a kernel that asserts the
    ids' order itself."""
    u = uids.shape[0]
    cuda.require(uids, "uids", torch.int32, (u,), dev)
    cuda.require(payload, "payload", torch.float32, (3 + k, u), dev)
    segs = _segments(uids, seg_len)
    if order and segs.shape[1] > 1:
        # runs of equal ids must be consecutive; checked on the device,
        # without a host sync
        torch._assert_async(torch.all(segs[:, 1:] >= segs[:, :-1]),
                            f"{entry}: uids must be non-decreasing"
                            + ("" if seg_len is None else
                               " within each segment"))


def _segments(uids: torch.Tensor, seg_len: int | None) -> torch.Tensor:
    """The stream as [S, C] segments (one segment without ``seg_len``);
    raises unless ``seg_len`` divides its length."""
    u = uids.shape[0]
    if seg_len is None:
        return uids[None]
    if seg_len <= 0 or u % seg_len:
        raise ValueError(f"seg_len {seg_len} does not divide the stream's "
                         f"{u} lanes")
    return uids.view(u // seg_len, seg_len)


def _apply_rowmajor(state: PackedFMState, uids: torch.Tensor,
                    payload: torch.Tensor, param: FMParam,
                    vec: int = 0, seg_len: int | None = None
                    ) -> PackedFMState:
    """Launch the row-major apply (``vec`` as in :func:`_pull_rowmajor`),
    over segments of ``seg_len`` lanes when it is given (K1)."""
    n, k = state.num_rows, state.k
    dev = state.device
    cuda.require(state.tbl, "tbl", torch.float32, (n, 4 + 2 * k), dev)
    _check_stream("apply_rowmajor", uids, payload, k, dev, order=False,
                  seg_len=seg_len)
    name, segs = (("apply_rowmajor", ()) if seg_len is None
                  else ("apply_rowmajor_segs", (seg_len,)))
    rc = getattr(cuda.library(), "dft_" + name)(
        state.tbl.data_ptr(), uids.data_ptr(), payload.data_ptr(), n, k,
        uids.shape[0], *segs, *updater_args(param), vec, cuda.stream(dev),
    )
    cuda.check(rc, name)
    cuda.LAUNCHES[name] += 1
    return state


def apply_pairs_segs_plain(state, uids: torch.Tensor,
                           payload: torch.Tensor, param: FMParam,
                           seg_len: int):
    """The plain version of K1 (``apply_pairs`` with ``seg_len``): a
    stable sort of the ids, then :func:`apply_pairs_plain`, which sums
    each row in lane order of the sorted stream: segment first, then
    lane, the kernels' order."""
    _segments(uids, seg_len)
    order = torch.sort(uids, stable=True).indices
    return apply_pairs_plain(state, uids[order], payload[:, order], param)


def apply_pairs(state, uids: torch.Tensor, payload: torch.Tensor,
                param: FMParam, seg_len: int | None = None):
    """Update ``state`` (FMState or PackedFMState) IN PLACE from the
    planar payload ``[3+K, U]`` (gw | gV | add_cnt | touch) over
    non-decreasing ``uids`` (i32, sentinel ``N`` pads): once per touched
    table row, the w updater (tail filter applied), ``cnt += add_cnt``,
    and the V updater gated by the pre-update count. In place replaces the
    TPU kernel's ``input_output_aliases``; returns ``state`` for
    chaining. The two layouts' kernels give the same bits.

    ``seg_len=C`` (K1, the sharded store owner's receive stream): ``uids``
    is ``U // C`` segments of C lanes, each non-decreasing with its
    sentinels at its end, and an id may repeat across segments; each
    touched row is updated once from its payload summed over all its
    lanes, segment first, then lane (``apply_pairs_segs`` and
    ``apply_rowmajor_segs``, counted apart from the one-stream kernels).
    ``seg_len=None`` is the one-stream contract."""
    if uids.device.type == "cpu":
        if seg_len is not None:
            return apply_pairs_segs_plain(state, uids, payload, param,
                                          seg_len)
        return apply_pairs_plain(state, uids, payload, param)
    if isinstance(state, PackedFMState):
        return _apply_rowmajor(state, uids, payload, param, seg_len=seg_len)
    if seg_len is not None:
        return _launch_apply("apply_pairs_segs", state, uids, payload, param,
                             seg_len=seg_len)
    return _launch_apply("apply_pairs", state, uids, payload, param)


# ---------------------------------------------------------------------------
# apply on planar leaves by csrc/planar_apply.cu's entries
# ---------------------------------------------------------------------------

# The designs of the planar apply's two wrappers (this module's
# ``apply_pairs2`` and probes/hw_packed_pairs.py's ``apply_packed``), named
# by stage words that are flags of csrc/planar_apply.cu's C entries.
# ``lanes``, the default of both, is csrc/apply_pairs.cu's kernel (a lane a
# thread) on the entry's leaves; ``tiles`` is the design for the card's
# scattered sectors (staged tiles, compacted rows), which measured 0.5-4.5 %
# slower than it (PERF.md); ``rmwonly``, the tiles' floor, stages,
# compacts, loads every leaf the update would touch and stores it back as
# loaded, so the state keeps its bits. No path of the package calls either
# wrapper.
PLANAR_APPLY_STAGES = {"lanes": 0, "tiles": 1, "rmwonly": 2}


def planar_apply_flags(stage: str) -> int:
    """The C entries' flags of a stage word."""
    if stage not in PLANAR_APPLY_STAGES:
        raise ValueError(f"stage {stage!r} not in "
                         f"{sorted(PLANAR_APPLY_STAGES)}")
    return PLANAR_APPLY_STAGES[stage]


def apply_pairs2_plain(state: FMState, uids: torch.Tensor,
                       payload: torch.Tensor, param: FMParam) -> FMState:
    """The plain version of ``apply_pairs2``: it computes the function of
    ``apply_pairs``, so it is :func:`apply_pairs_plain` (planar states
    only, as the kernel)."""
    require_planar(state, "apply_pairs2")
    return apply_pairs_plain(state, uids, payload, param)


def apply_pairs2(state: FMState, uids: torch.Tensor, payload: torch.Tensor,
                 param: FMParam, stage: str = "lanes") -> FMState:
    """:func:`apply_pairs` on a planar state, by csrc/planar_apply.cu's
    entry: ``stage`` names the design or the floor
    (:data:`PLANAR_APPLY_STAGES`; ``lanes``, the default, is the kernel of
    :func:`apply_pairs`, ``tiles`` the design that stages a tile's uids and
    scalar payload rows in shared memory and compacts the touched rows and
    then the rows past the V gate, so that no lane idles on a leaf); the
    floor ``rmwonly`` returns ``state`` with its bits. Port of
    ``difacto_tpu/ops/pair_sweep.py::apply_pairs2``, whose ``DualPairMeta``
    schedule (two unique windows per grid step) is Mosaic's mechanism:
    this wrapper takes none. No path of the package calls it;
    probes/hw_apply2.py and chip_smoke.py time its designs against
    :func:`apply_pairs`."""
    flags = planar_apply_flags(stage)
    require_planar(state, "apply_pairs2")
    if uids.device.type == "cpu":
        if stage == "rmwonly":
            return state
        return apply_pairs_plain(state, uids, payload, param)
    return _launch_apply("apply_pairs2", state, uids, payload, param, flags)
