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

``apply_pairs`` with ``seg_len`` (K1, the sharded store owner's stream of
S sorted segments) launches two kernels: csrc/seg_merge.cu's stable merge
of the segments, then the one-stream apply on the merged stream. K1's
first design, a binary search into every other segment for each payload
row a row sums (csrc/pair_runs.cuh), stays as
:func:`apply_pairs_segs_search`, the yardstick that no path calls.

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
                  seg_len: int | None = None, count: str | None = None,
                  order: bool = True) -> FMState:
    """Check what the apply kernels take and launch the one named
    ``entry`` (``apply_pairs``, ``apply_pairs2`` or, over segments of
    ``seg_len`` lanes, ``apply_pairs_segs``: one contract), with ``extra``
    arguments before the stream; count the launch under ``count``
    (default ``entry``); ``order`` as in :func:`_check_stream`."""
    n, k, u = state.num_rows, state.k, uids.shape[0]
    dev = state.device
    for name in ("w", "z", "n", "cnt"):
        cuda.require(getattr(state, name), name, torch.float32, (n,), dev)
    for name in ("V", "nV"):
        cuda.require(getattr(state, name), name, torch.float32, (k, n), dev)
    _check_stream(entry, uids, payload, k, dev, order=order, seg_len=seg_len)
    segs = () if seg_len is None else (seg_len,)
    rc = getattr(cuda.library(), "dft_" + entry)(
        state.w.data_ptr(), state.z.data_ptr(), state.n.data_ptr(),
        state.cnt.data_ptr(), state.V.data_ptr(), state.nV.data_ptr(),
        uids.data_ptr(), payload.data_ptr(), n, k, u, *segs,
        *updater_args(param), *extra, cuda.stream(dev),
    )
    cuda.check(rc, entry)
    cuda.LAUNCHES[count or entry] += 1
    return state


def _check_stream(entry: str, uids: torch.Tensor, payload: torch.Tensor,
                  k: int, dev: torch.device, order: bool = True,
                  seg_len: int | None = None) -> None:
    """What every apply kernel takes as its id stream and payload: one
    non-decreasing stream, or (``seg_len``) segments of ``seg_len`` lanes,
    each non-decreasing. ``order=False`` for a kernel that asserts the
    ids' order itself, and for a stream that :func:`merge_segments`
    merged (its kernel asserts the segments' order)."""
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
                    vec: int = 0, seg_len: int | None = None,
                    count: str = "apply_rowmajor") -> PackedFMState:
    """Launch the row-major apply (``vec`` as in :func:`_pull_rowmajor`),
    over segments of ``seg_len`` lanes by the search design when it is
    given; count the launch under ``count``."""
    n, k = state.num_rows, state.k
    dev = state.device
    cuda.require(state.tbl, "tbl", torch.float32, (n, 4 + 2 * k), dev)
    _check_stream("apply_rowmajor", uids, payload, k, dev, order=False,
                  seg_len=seg_len)
    entry, segs = (("apply_rowmajor", ()) if seg_len is None
                   else ("apply_rowmajor_segs", (seg_len,)))
    rc = getattr(cuda.library(), "dft_" + entry)(
        state.tbl.data_ptr(), uids.data_ptr(), payload.data_ptr(), n, k,
        uids.shape[0], *segs, *updater_args(param), vec, cuda.stream(dev),
    )
    cuda.check(rc, entry)
    cuda.LAUNCHES[count] += 1
    return state


# ---------------------------------------------------------------------------
# K1: the apply over the sharded store owner's receive stream, S segments
# of C lanes, each non-decreasing, ids repeated across segments
# ---------------------------------------------------------------------------


def merge_segments_plain(uids: torch.Tensor, payload: torch.Tensor,
                         seg_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`merge_segments`: a stable sort of the
    ids, and the payload's columns gathered in its order."""
    _segments(uids, seg_len)
    order = torch.sort(uids, stable=True).indices
    return uids[order], payload[:, order]


def merge_segments(uids: torch.Tensor, payload: torch.Tensor,
                   seg_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's first pass (csrc/seg_merge.cu): ``uids`` (i32) is segments of
    ``seg_len`` lanes, each non-decreasing (the kernel asserts it), and
    ``payload`` planar ``[P, U]``. Returns the merged stream, non-decreasing,
    and the payload's columns in its order, new tensors; equal ids keep
    the lower segment first, then the lower lane: a stable sort's order."""
    if uids.device.type == "cpu":
        return merge_segments_plain(uids, payload, seg_len)
    u, dev = uids.shape[0], uids.device
    _segments(uids, seg_len)
    cuda.require(uids, "uids", torch.int32, (u,), dev)
    cuda.require(payload, "payload", torch.float32, (payload.shape[0], u),
                 dev)
    mu, mp = torch.empty_like(uids), torch.empty_like(payload)
    rc = cuda.library().dft_merge_segments(
        uids.data_ptr(), payload.data_ptr(), mu.data_ptr(), mp.data_ptr(), u,
        seg_len, payload.shape[0], cuda.raw_stream(dev))
    cuda.check(rc, "merge_segments")
    cuda.LAUNCHES["merge_segments"] += 1
    return mu, mp


def apply_pairs_segs_plain(state, uids: torch.Tensor,
                           payload: torch.Tensor, param: FMParam,
                           seg_len: int):
    """The plain version of K1 (``apply_pairs`` with ``seg_len``):
    :func:`merge_segments_plain`, then :func:`apply_pairs_plain`, which
    sums each row in lane order of the merged stream: segment first, then
    lane, the kernels' order."""
    return apply_pairs_plain(state, *merge_segments_plain(uids, payload,
                                                          seg_len), param)


def _apply_segs(state, uids: torch.Tensor, payload: torch.Tensor,
                param: FMParam, seg_len: int):
    """K1 on the card: :func:`merge_segments`, then the one-stream apply
    kernel of the state's layout on the merged stream, counted once, under
    K1's name (``apply_pairs_segs`` or ``apply_rowmajor_segs``)."""
    _check_stream("merge_segments", uids, payload, state.k, state.device,
                  order=False, seg_len=seg_len)
    mu, mp = merge_segments(uids, payload, seg_len)
    if isinstance(state, PackedFMState):
        return _apply_rowmajor(state, mu, mp, param,
                               count="apply_rowmajor_segs")
    return _launch_apply("apply_pairs", state, mu, mp, param,
                         count="apply_pairs_segs", order=False)


def apply_pairs_segs_search(state, uids: torch.Tensor,
                            payload: torch.Tensor, param: FMParam,
                            seg_len: int):
    """K1 by its first design, the yardstick of the merge: no merge; the
    lane that owns a row (first of its id in its segment, no earlier
    segment holding it) sums its run, then the id's run in each later
    segment, found by a binary search for every payload row it sums
    (csrc/pair_runs.cuh; ``apply_pairs_segs_kernel`` on planar leaves,
    ``rowmajor_apply_kernel<VEC, true>`` on the row-major table). The
    same bits as :func:`apply_pairs` with ``seg_len``; counted under
    ``apply_pairs_segs_search`` or ``apply_rowmajor_segs_search``. No path
    of the package calls it."""
    if uids.device.type == "cpu":
        return apply_pairs_segs_plain(state, uids, payload, param, seg_len)
    if isinstance(state, PackedFMState):
        return _apply_rowmajor(state, uids, payload, param, seg_len=seg_len,
                               count="apply_rowmajor_segs_search")
    return _launch_apply("apply_pairs_segs", state, uids, payload, param,
                         seg_len=seg_len, count="apply_pairs_segs_search")


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
    lanes, segment first, then lane. On the card :func:`merge_segments`
    merges the segments into one sorted stream and the one-stream kernel
    applies it, counted under ``apply_pairs_segs`` or
    ``apply_rowmajor_segs`` (beside ``merge_segments``), not under the
    one-stream names. ``seg_len=None`` is the one-stream contract."""
    if uids.device.type == "cpu":
        if seg_len is not None:
            return apply_pairs_segs_plain(state, uids, payload, param,
                                          seg_len)
        return apply_pairs_plain(state, uids, payload, param)
    if seg_len is not None:
        return _apply_segs(state, uids, payload, param, seg_len)
    if isinstance(state, PackedFMState):
        return _apply_rowmajor(state, uids, payload, param)
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
