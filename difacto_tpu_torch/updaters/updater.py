"""Server-side optimizer state and its plain updates.

Port of ``difacto_tpu/updaters/updater.py`` (reference:
``include/difacto/updater.h`` and ``src/sgd/sgd_updater.h`` ::
SGDUpdater): dense tables over the hashed id space, with the reference's
lazy V *allocation* turned into lazy *activation* (V rows exist from the
start but enter predictions and receive updates only once ``cnt >=
V_threshold``). Two layouts: planar (:class:`FMState`, one array per
leaf) and row-major (:class:`PackedFMState`, ``layout=packed``: one
``[N, 4+2K]`` table); the stacked and hot/cold layouts are not ported.

``pull`` and ``update`` here are the plain PyTorch reference of the table
path (gather -> vector math -> masked delta scatter-add). The train step
itself runs the hand-written kernels of ops/pair_sweep.py, whose plain
versions are held against these by the tests.

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
    """Updater over the state's tensors; ``param`` values are fixed. Every
    method takes either layout (FMState planar / PackedFMState)."""

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

    # -- Get (reference: SGDUpdater::Get) -------------------------------------

    def pull(self, state, uids: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """Rows [U, 1+K]: w then V. V is zero until activated (cnt >=
        V_threshold); invalid (padded) lanes are fully zero."""
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
    ):
        """The plain reference update: gathers, vector math, and masked
        deltas scatter-added back — in place on ``state``'s tensors (for
        a PackedFMState, through the column views into its table)."""
        p = self.param
        idx = torch.where(valid, uids, 0).long()
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
        state.w.index_add_(0, idx, m * (w_new - w_u))
        state.z.index_add_(0, idx, m * (z_new - z_u))
        state.n.index_add_(0, idx, m * (n_new - n_u))
        state.cnt.index_add_(0, idx, valid.to(torch.float32) * add_cnt)
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
            state.V.index_add_(1, idx, mV * (V_new - V_u))
            state.nV.index_add_(1, idx, mV * (nV_new - nV_u))
        return state

    # -- feature counts (reference: the kFeaCount push) -----------------------

    def add_counts(self, state, ids: torch.Tensor):
        """state.cnt[id] += occurrences, in place, either layout; negative
        ids (padding) are skipped."""
        ids = ids.reshape(-1)
        keep = ids >= 0
        state.cnt.index_add_(0, ids[keep].long(),
                             torch.ones_like(ids[keep], dtype=torch.float32))
        return state

    # -- observability --------------------------------------------------------

    def stats(self, state) -> dict[str, float]:
        """nnz(w) / active-V counts (the capacity observables the reference
        prints in Progress rows), either layout."""
        out = {"nnz_w": float((state.w != 0).sum())}
        if self.param.V_dim > 0:
            out["nnz_V"] = float((state.cnt >= self.param.V_threshold).sum())
        else:
            out["nnz_V"] = 0.0
        return out
