"""Server-side optimizer state and its plain updates.

Port of ``difacto_tpu/updaters/updater.py`` (reference:
``include/difacto/updater.h`` and ``src/sgd/sgd_updater.h`` ::
SGDUpdater): dense tables over the hashed id space, with the reference's
lazy V *allocation* turned into lazy *activation* (V rows exist from the
start but enter predictions and receive updates only once ``cnt >=
V_threshold``). Four layouts: planar (:class:`FMState`, one array per
leaf), row-major (:class:`PackedFMState`, ``layout=packed``: one
``[N, 4+2K]`` table), stacked (:class:`StackedFMState`,
``layout=stacked``: one ``[4+2K, N]`` table) and the hot/cold split of
the stacked table (:class:`HotColdFMState`, ``hot_rows``).

``pull`` and ``update`` here are the table path of ``kernel=xla``
(gather -> vector math -> masked delta scatter-add, PyTorch tensor ops,
as the JAX package's are XLA ops); on the other paths the train step runs
the hand-written kernels of ops/pair_sweep.py and ops/sweep.py, whose
plain versions the tests hold against these.

JAX gathers out-of-range indices as zero (``mode="fill"``) and drops
out-of-range scatters (``mode="drop"``); PyTorch has neither. Here a
gather clamps its indices and zeroes the lanes out of range, and a
scatter-add gives those lanes (and the invalid lanes of the planar and
row-major updates) a delta of exactly ``-0.0``: ``x + (-0.0)`` is ``x``
bit for bit for every ``x``, ``-0.0`` included, so the lanes leave the
table as a dropped scatter does, in any order of the card's atomic adds.

Update math (FTRL, reference SGDUpdater::UpdateW):
    n' = n + g^2;  sigma = (sqrt(n') - sqrt(n)) / lr_eta
    z' = z + g - sigma * w
    w' = 0                                   if |z'| <= l1
         -(z' - sign(z')*l1) / ((lr_beta + sqrt(n'))/lr_eta + l2)  otherwise
AdaGrad (reference SGDUpdater::UpdateV):
    g' = g + l2 * v;  n' = n + g'^2;  v' = v - lr_eta * g' / (sqrt(n') + lr_beta)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import FMParam
from ..utils.tracing import to_host


@dataclass
class FMState:
    """Dense table state (rows = hashed feature ids), planar: V/nV are
    factor-major [K, N], the layout of the JAX package's FMState and of
    the checkpoint format. Tensors all lie on one device; the kernels
    update them in place."""

    w: torch.Tensor     # f32 [N]    linear weights
    z: torch.Tensor     # f32 [N]    FTRL z (unused for adagrad/sgd w)
    n: torch.Tensor     # f32 [N]    squared-grad accumulator for w
    V: torch.Tensor     # f32 [K, N] latent factors (planar)
    nV: torch.Tensor    # f32 [K, N] squared-grad accumulator for V (planar)
    cnt: torch.Tensor   # f32 [N]    feature occurrence counts (kFeaCount)

    @property
    def num_rows(self) -> int:
        return self.w.shape[0]

    @property
    def k(self) -> int:
        return self.V.shape[0]

    @property
    def device(self) -> torch.device:
        return self.w.device


LEAVES = ("w", "z", "n", "V", "nV", "cnt")


def leaf_planes(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's [N] planes: [1, N] for w, z, n, cnt; V, nV as they are."""
    return leaf[None] if leaf.dim() == 1 else leaf


@dataclass
class PackedFMState:
    """Row-major state (``layout=packed``): ONE table ``[N, 4+2K]`` with
    columns w|z|n|cnt|V|nV, the JAX package's ``PackedFMState``. One id's
    state is 16 + 8K contiguous bytes, which is what the card's memory
    system wants from a scattered row update (csrc/rowmajor_pairs.cu).

    The six leaves are VIEWS of the table's columns (V and nV as
    ``[K, N]``, strided): indexing them reads the table, an in-place
    update through one writes the table. So the plain PyTorch code written
    for :class:`FMState` (the updater below, the kernels' plain versions)
    runs unchanged on either layout; only the kernel wrappers tell them
    apart."""

    tbl: torch.Tensor   # f32 [N, 4+2K]

    @property
    def num_rows(self) -> int:
        return self.tbl.shape[0]

    @property
    def k(self) -> int:
        return (self.tbl.shape[1] - 4) // 2

    @property
    def device(self) -> torch.device:
        return self.tbl.device

    @property
    def w(self) -> torch.Tensor:
        return self.tbl[:, 0]

    @property
    def z(self) -> torch.Tensor:
        return self.tbl[:, 1]

    @property
    def n(self) -> torch.Tensor:
        return self.tbl[:, 2]

    @property
    def cnt(self) -> torch.Tensor:
        return self.tbl[:, 3]

    @property
    def V(self) -> torch.Tensor:
        return self.tbl[:, 4:4 + self.k].T

    @property
    def nV(self) -> torch.Tensor:
        return self.tbl[:, 4 + self.k:].T


@dataclass
class StackedFMState:
    """Stacked state (``layout=stacked``): ONE table ``[4+2K, N]`` with
    rows w|z|n|cnt|V|nV, the JAX package's ``StackedFMState``: the
    ``kernel=xla`` path's table, one gather and one scatter-add a step.
    The six leaves are views of its rows (V and nV as ``[K, N]``,
    contiguous), as :class:`PackedFMState`'s are of its columns."""

    tbl: torch.Tensor   # f32 [4+2K, N]

    @property
    def num_rows(self) -> int:
        return self.tbl.shape[1]

    @property
    def k(self) -> int:
        return (self.tbl.shape[0] - 4) // 2

    @property
    def device(self) -> torch.device:
        return self.tbl.device

    @property
    def w(self) -> torch.Tensor:
        return self.tbl[0]

    @property
    def z(self) -> torch.Tensor:
        return self.tbl[1]

    @property
    def n(self) -> torch.Tensor:
        return self.tbl[2]

    @property
    def cnt(self) -> torch.Tensor:
        return self.tbl[3]

    @property
    def V(self) -> torch.Tensor:
        return self.tbl[4:4 + self.k]

    @property
    def nV(self) -> torch.Tensor:
        return self.tbl[4 + self.k:]


@dataclass
class HotColdFMState:
    """Frequency-split stacked state (``hot_rows``): TWO tables
    ``[4+2K, H]`` and ``[4+2K, N-H]``, the JAX package's
    ``HotColdFMState``. Row r of the remapped table (data/remap.py
    relabels rows so that the hottest H of a count sample are [0, H))
    lives in ``hot[:, r]`` when r < H, else in ``cold[:, r - H]``. The
    remap is a per-run layout: checkpoints hold canonical hash rows
    (utils/checkpoint.py). The JAX package split the table for a TPU
    scatter cliff; on this card it is a measurement (PERF.md)."""

    hot: torch.Tensor   # f32 [4+2K, H]   remapped rows [0, H)
    cold: torch.Tensor  # f32 [4+2K, N-H] remapped rows [H, N) at r - H

    @property
    def num_rows(self) -> int:
        return self.hot.shape[1] + self.cold.shape[1]

    @property
    def hot_rows(self) -> int:
        return self.hot.shape[1]

    @property
    def k(self) -> int:
        return (self.hot.shape[0] - 4) // 2

    @property
    def device(self) -> torch.device:
        return self.hot.device


def _gather_cols(tbl: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``tbl[:, ids]`` [D, U], zero where an id is out of range (JAX's
    fill-0 gather)."""
    ncols = tbl.shape[1]
    inr = (ids >= 0) & (ids < ncols)
    got = tbl.index_select(1, ids.clamp(0, max(ncols - 1, 0)).long())
    return torch.where(inr[None, :], got, 0.0)


def _add_cols(tbl: torch.Tensor, ids: torch.Tensor,
              delta: torch.Tensor) -> None:
    """``tbl[:, ids] += delta`` in place, the out-of-range ids dropped
    (their lanes add ``-0.0``, the identity of float addition)."""
    ncols = tbl.shape[1]
    inr = (ids >= 0) & (ids < ncols)
    tbl.index_add_(1, ids.clamp(0, max(ncols - 1, 0)).long(),
                   torch.where(inr[None, :], delta, -0.0))


def stack_state(state) -> StackedFMState:
    """A state with the six leaves (FMState, PackedFMState) ->
    StackedFMState, a copy."""
    return StackedFMState(tbl=torch.cat(
        [state.w[None], state.z[None], state.n[None], state.cnt[None],
         state.V, state.nV], dim=0))


def unstack_state(stacked: StackedFMState) -> FMState:
    """StackedFMState -> FMState (planar, contiguous), a copy."""
    return FMState(**{k: getattr(stacked, k).clone() for k in LEAVES})


def pack_state(state: FMState) -> PackedFMState:
    """FMState (planar) -> PackedFMState, a copy."""
    cols = [state.w[:, None], state.z[:, None], state.n[:, None],
            state.cnt[:, None], state.V.T, state.nV.T]
    return PackedFMState(tbl=torch.cat(cols, dim=1))


def unpack_state(packed: PackedFMState) -> FMState:
    """PackedFMState -> FMState (planar, contiguous), a copy."""
    return FMState(**{
        k: getattr(packed, k).clone(memory_format=torch.contiguous_format)
        for k in LEAVES})


def require_planar(state, what: str) -> None:
    """Raise on a state that ``what`` (a kernel that reads planar leaves)
    does not take."""
    if not isinstance(state, FMState):
        raise TypeError(
            f"{what} reads the planar leaves of an FMState (V [K, N]); got "
            f"{type(state).__name__}. The row-major table (layout=packed) "
            "goes through pull_pairs / apply_pairs and the sweep "
            "wrappers")


def ftrl_w(g, w, z, n, p: FMParam):
    """FTRL-proximal on w: (w_new, z_new, n_new). One home for the formula
    order, which the apply kernel repeats (csrc/apply_pairs.cu)."""
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / p.lr_eta
    z_new = z + g - sigma * w
    w_new = torch.where(
        torch.abs(z_new) <= p.l1,
        torch.zeros_like(z_new),
        -(z_new - torch.sign(z_new) * p.l1)
        / ((p.lr_beta + torch.sqrt(n_new)) / p.lr_eta + p.l2),
    )
    return w_new, z_new, n_new


def adagrad_w(g, w, n, p: FMParam):
    g_r = g + p.l2 * w
    n_new = n + g_r * g_r
    return w - p.lr_eta * g_r / (torch.sqrt(n_new) + p.lr_beta), n_new


def sgd_w(g, w, p: FMParam):
    return w - p.lr_eta * (g + p.l2 * w)


def adagrad_v(gv, v, nv, p: FMParam):
    gv_r = gv + p.V_l2 * v
    nv_new = nv + gv_r * gv_r
    return v - p.V_lr_eta * gv_r / (torch.sqrt(nv_new) + p.V_lr_beta), nv_new


def sgd_v(gv, v, p: FMParam):
    return v - p.V_lr_eta * (gv + p.V_l2 * v)


class FMUpdater:
    """Updater over the state's tensors; ``param`` values are fixed.
    ``pull``/``update`` take the planar, row-major and stacked layouts;
    the split state goes through ``pull_raw_split``/``update_split``."""

    def __init__(self, param: FMParam):
        self.param = param

    # -- creation -------------------------------------------------------------

    def init_state(self, num_rows: int, seed: int, device) -> FMState:
        """Fresh state on ``device``: V ~ uniform(-V_init_scale,
        +V_init_scale) from an explicit ``torch.Generator(seed)`` on that
        device. These are not ``jax.random``'s bits; tests that compare the
        two packages start both from one NumPy state instead."""
        p = self.param
        k = p.V_dim
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        V = torch.rand((k, num_rows), generator=gen, device=device)
        V.mul_(2.0).sub_(1.0).mul_(p.V_init_scale)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return FMState(w=zeros(num_rows), z=zeros(num_rows), n=zeros(num_rows),
                       V=V, nV=zeros(k, num_rows), cnt=zeros(num_rows))

    def init_state_packed(self, num_rows: int, seed: int,
                          device) -> PackedFMState:
        """The values of ``pack_state(init_state(...))`` (the same draw
        from the same generator) without holding the planar state beside
        the table: the table is allocated once and V written into its
        columns."""
        p = self.param
        k = p.V_dim
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        V = torch.rand((k, num_rows), generator=gen, device=device)
        V.mul_(2.0).sub_(1.0).mul_(p.V_init_scale)
        tbl = torch.zeros((num_rows, 4 + 2 * k), dtype=torch.float32,
                          device=device)
        tbl[:, 4:4 + k] = V.T
        return PackedFMState(tbl=tbl)

    def _stacked_table(self, num_rows: int, gen: torch.Generator,
                       device: torch.device) -> torch.Tensor:
        """A zero ``[4+2K, num_rows]`` table with V drawn into its rows
        as :meth:`init_state` draws it (the same generator calls)."""
        p = self.param
        k = p.V_dim
        tbl = torch.zeros((4 + 2 * k, num_rows), dtype=torch.float32,
                          device=device)
        V = tbl[4:4 + k]
        V.uniform_(0.0, 1.0, generator=gen)  # torch.rand's draw, in place
        V.mul_(2.0).sub_(1.0).mul_(p.V_init_scale)
        return tbl

    def init_state_stacked(self, num_rows: int, seed: int,
                           device) -> StackedFMState:
        """The values of ``stack_state(init_state(...))`` built low-peak:
        the table is allocated once and V is drawn into its rows (at
        2^26 rows and K = 16 the planar state beside it would be another
        9.7 GB)."""
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return StackedFMState(tbl=self._stacked_table(num_rows, gen, device))

    def init_state_hotcold(self, num_rows: int, hot_rows: int, seed: int,
                           device) -> HotColdFMState:
        """Fresh frequency-split state: the hot table's V then the cold
        table's from one generator (the remap permutes rows anyway, so an
        iid draw is an iid draw; these are not the JAX package's bits)."""
        if not 0 < hot_rows < num_rows:
            raise ValueError(f"hot_rows {hot_rows} out of range for a "
                             f"{num_rows}-row table")
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        hot = self._stacked_table(hot_rows, gen, device)
        return HotColdFMState(
            hot=hot, cold=self._stacked_table(num_rows - hot_rows, gen,
                                              device))

    # -- Get (reference: SGDUpdater::Get) -------------------------------------

    def pull_raw(self, state: StackedFMState, uids: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        """The stacked table's ONE ``[D, U]`` gather, which the train step
        shares between the pull and the update. ``uids`` are sorted
        unique with out-of-range sentinels on the pad lanes (prep and
        :func:`ops.localize.localize` give both)."""
        return _gather_cols(state.tbl, uids)

    def pull_raw_split(self, state: HotColdFMState, uids_h: torch.Tensor,
                       uids_c: torch.Tensor) -> torch.Tensor:
        """``[D, Ch+Cc]`` raw rows from the split tables: the hot bucket
        gathers the small table, the cold bucket (global remapped ids)
        the big one. Hot pads carry H and cold pads N, both out of range
        for their table, so they gather zeros."""
        H = state.hot_rows
        return torch.cat([_gather_cols(state.hot, uids_h),
                          _gather_cols(state.cold, uids_c - H)], dim=1)

    def rows_view(self, rows: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        """:meth:`pull_raw`'s ``[D, U]`` -> the worker's ``[U, 1+K]``
        (w | V gated by ``cnt >= V_threshold``)."""
        k = self.param.V_dim
        w = rows[0] * valid.to(torch.float32)
        if k == 0:
            return w[:, None]
        active = valid & (rows[3] >= self.param.V_threshold)
        V = rows[4:4 + k].T * active[:, None].to(torch.float32)
        return torch.cat([w[:, None], V], dim=1)

    def pull(self, state, uids: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """Rows [U, 1+K]: w then V. V is zero until activated (cnt >=
        V_threshold); invalid (padded) lanes are fully zero."""
        if isinstance(state, StackedFMState):
            return self.rows_view(self.pull_raw(state, uids, valid), valid)
        idx = torch.where(valid, uids, 0).long()
        v = valid.to(torch.float32)
        w = state.w[idx] * v
        active = valid
        if self.param.V_dim > 0:
            active = active & (state.cnt[idx] >= self.param.V_threshold)
        V = state.V[:, idx].T * active[:, None].to(torch.float32)
        return torch.cat([w[:, None], V], dim=1)

    # -- Update (reference: SGDUpdater::Update) -------------------------------

    def update(
        self,
        state,                  # FMState or PackedFMState
        uids: torch.Tensor,     # i32 [U] unique table rows (sentinel pads)
        grads: torch.Tensor,    # f32 [U, 1+K] per-key aggregated gradients
        add_cnt: torch.Tensor,  # f32 [U] batch occurrence counts
        valid: torch.Tensor,    # bool [U]
        rows: torch.Tensor | None = None,  # stacked: the step's pull_raw
    ):
        """The table update: gathers, vector math, and masked deltas
        scatter-added back (``x + (x_new - x)``, as the JAX package adds
        them) — in place on ``state``'s tensors (for a PackedFMState,
        through the column views into its table). A StackedFMState takes
        one ``[D, U]`` gather (or the step's ``rows``) and one
        scatter-add; invalid lanes add ``-0.0`` (module docstring)."""
        if isinstance(state, StackedFMState):
            if rows is None:
                rows = self.pull_raw(state, uids, valid)
            _add_cols(state.tbl, uids,
                      self._stacked_delta(rows, grads, add_cnt, valid))
            return state
        p = self.param
        idx = torch.where(valid, uids, 0).long()

        def add(a, d, dim=0):
            keep = valid[None, :] if dim else valid
            a.index_add_(dim, idx, torch.where(keep, d, -0.0))

        g = grads[:, 0]
        w_u, z_u, n_u = state.w[idx], state.z[idx], state.n[idx]
        cnt_pre = state.cnt[idx]
        upd_w = valid
        if p.tail_feature_filter > 0:
            upd_w = upd_w & (cnt_pre >= p.tail_feature_filter)
        if p.w_updater == "ftrl":
            w_new, z_new, n_new = ftrl_w(g, w_u, z_u, n_u, p)
        elif p.w_updater == "adagrad":
            w_new, n_new = adagrad_w(g, w_u, n_u, p)
            z_new = z_u
        else:  # sgd
            w_new, z_new, n_new = sgd_w(g, w_u, p), z_u, n_u
        m = upd_w.to(torch.float32)
        add(state.w, m * (w_new - w_u))
        add(state.z, m * (z_new - z_u))
        add(state.n, m * (n_new - n_u))
        add(state.cnt, valid.to(torch.float32) * add_cnt)
        if p.V_dim > 0:
            # activation gate uses the PRE-update count (a row crossing the
            # threshold this batch gets its first V update next batch)
            active = valid & (cnt_pre >= p.V_threshold)
            if p.tail_feature_filter > 0:
                active = active & (cnt_pre >= p.tail_feature_filter)
            gV = grads[:, 1:].T                 # planar [K, U]
            V_u, nV_u = state.V[:, idx], state.nV[:, idx]
            if p.V_updater == "adagrad":
                V_new, nV_new = adagrad_v(gV, V_u, nV_u, p)
            else:  # sgd: nV untouched
                V_new, nV_new = sgd_v(gV, V_u, p), nV_u
            mV = active[None, :].to(torch.float32)
            add(state.V, mV * (V_new - V_u), 1)
            add(state.nV, mV * (nV_new - nV_u), 1)
        return state

    def update_split(self, state: HotColdFMState, uids_h: torch.Tensor,
                     uids_c: torch.Tensor, grads: torch.Tensor,
                     add_cnt: torch.Tensor, valid: torch.Tensor,
                     rows: torch.Tensor) -> HotColdFMState:
        """The stacked update as two scatter-adds over the split tables.
        ``rows`` is the step's :meth:`pull_raw_split` (lanes [0, Ch) hot,
        [Ch, Ch+Cc) cold)."""
        ch = uids_h.shape[0]
        delta = self._stacked_delta(rows, grads, add_cnt, valid)
        _add_cols(state.hot, uids_h, delta[:, :ch])
        _add_cols(state.cold, uids_c - state.hot_rows, delta[:, ch:])
        return state

    def _stacked_delta(self, rows: torch.Tensor, grads: torch.Tensor,
                       add_cnt: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
        """The ``[D, U]`` masked delta of the stacked layouts from the
        gathered rows: the planar update's math and masks (JAX
        ``updater.py::_stacked_delta``)."""
        p = self.param
        k = p.V_dim
        w, z, n, cnt = rows[0], rows[1], rows[2], rows[3]
        g = grads[:, 0]
        upd_w = valid
        if p.tail_feature_filter > 0:
            upd_w = upd_w & (cnt >= p.tail_feature_filter)
        if p.w_updater == "ftrl":
            w_new, z_new, n_new = ftrl_w(g, w, z, n, p)
        elif p.w_updater == "adagrad":
            w_new, n_new = adagrad_w(g, w, n, p)
            z_new = z
        else:  # sgd
            w_new, z_new, n_new = sgd_w(g, w, p), z, n
        m = upd_w.to(torch.float32)
        parts = [(m * (w_new - w))[None], (m * (z_new - z))[None],
                 (m * (n_new - n))[None],
                 (valid.to(torch.float32) * add_cnt)[None]]
        if k > 0:
            # the V gate reads the PRE-update count, as the planar path
            V, nV = rows[4:4 + k], rows[4 + k:]
            active = valid & (cnt >= p.V_threshold)
            if p.tail_feature_filter > 0:
                active = active & (cnt >= p.tail_feature_filter)
            gV = grads[:, 1:].T
            if p.V_updater == "adagrad":
                V_new, nV_new = adagrad_v(gV, V, nV, p)
            else:  # sgd
                V_new, nV_new = sgd_v(gV, V, p), nV
            mV = active[None, :].to(torch.float32)
            parts += [mV * (V_new - V), mV * (nV_new - nV)]
        return torch.cat(parts, dim=0)

    # -- feature counts (reference: the kFeaCount push) -----------------------

    def add_counts(self, state, ids: torch.Tensor):
        """state.cnt[id] += occurrences, in place, any layout; negative
        ids (padding) are skipped. A HotColdFMState takes remapped ids,
        each into its own table."""
        ids = ids.reshape(-1)
        if isinstance(state, HotColdFMState):
            H = state.hot_rows
            for tbl, sel, off in ((state.hot, (ids >= 0) & (ids < H), 0),
                                  (state.cold, ids >= H, H)):
                tbl[3].index_add_(0, (ids[sel] - off).long(),
                                  torch.ones_like(ids[sel],
                                                  dtype=torch.float32))
            return state
        keep = ids >= 0
        state.cnt.index_add_(0, ids[keep].long(),
                             torch.ones_like(ids[keep], dtype=torch.float32))
        return state

    # -- observability --------------------------------------------------------

    def stats(self, state) -> dict[str, float]:
        """nnz(w) / active-V counts (the capacity observables the reference
        prints in Progress rows), any layout (a HotColdFMState summed over
        its two tables)."""
        if isinstance(state, HotColdFMState):
            parts = [(t[0], t[3]) for t in (state.hot, state.cold)]
        else:
            parts = [(state.w, state.cnt)]
        nnz_w = sum((w != 0).sum() for w, _ in parts)
        out = {"nnz_w": float(to_host(nnz_w))}
        if self.param.V_dim > 0:
            t = self.param.V_threshold
            out["nnz_V"] = float(to_host(sum((c >= t).sum()
                                             for _, c in parts)))
        else:
            out["nnz_V"] = 0.0
        return out
