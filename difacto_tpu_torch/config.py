"""Typed configuration.

Copy of ``difacto_tpu/config.py`` (the port imports nothing of the JAX
package): the same dataclasses and the same keys, so a config written for
the JAX package parses here unchanged and an unknown key stays fatal.

The port carries every setting of the JAX package. A multi-process
launch is not a setting but an environment (parallel/multihost.py).
Its own model, AutoInt (``loss=autoint``, models/autoint.py), reads the
keys of :class:`AutoIntParam`, which the same ``from_kwargs`` parses into
``Config.autoint``: an attribute beside the four parts, not a fifth
dataclass field, so that the parts stay the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from .base import KWArgs


def _coerce(val: str, typ: Any) -> Any:
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


@dataclass
class ParamBase:
    """dmlc::Parameter-style: init from kwargs, return unconsumed pairs."""

    def init(self, kwargs: KWArgs) -> KWArgs:
        names = {f.name: f for f in dataclasses.fields(self)}
        rest: KWArgs = []
        for k, v in kwargs:
            f = names.get(k)
            if f is None:
                rest.append((k, v))
                continue
            setattr(self, k, _coerce(v, _resolve_type(f)))
        self.validate()
        return rest

    def validate(self) -> None:  # range checks, like DMLC_DECLARE_FIELD().set_range
        pass


def _resolve_type(f: dataclasses.Field) -> type:
    t = f.type
    if isinstance(t, type):
        return t
    # dataclass stores annotations as strings under `from __future__ import annotations`
    return {"int": int, "float": float, "str": str, "bool": bool}.get(str(t), str)


@dataclass
class DataParam(ParamBase):
    """Data pipeline knobs (the data_* fields of the reference's
    SGDLearnerParam plus the static-shape padding policy)."""

    data_in: str = ""              # training data URI (file, dir, or glob)
    data_val: str = ""             # validation data URI
    data_format: str = "libsvm"    # libsvm | libffm | csr
    batch_size: int = 8192         # examples per step
    shuffle: bool = True           # shuffle batches within a file part
    num_parts_per_file: int = 1    # split each file into N parts (InputSplit)
    max_nnz_per_row: int = 64      # pad/truncate each example to this nnz
    num_bits: int = 22             # hashed feature space = 2**num_bits rows
    host_localize: bool = True     # dedup ids in the prep threads; 0 =
                                   # dedup on the device (ops/localize.py)
    prep_workers: int = 0          # threads for batch dedup/sort prep;
                                   # 0 = auto (cpu_count - 2, capped at 4)
    batch_workers: int = 2         # threads for hashing + [B,L] padding
                                   # (1 = serial; replays depend on it)
    cache_batches: bool = False    # keep epoch-0 prepped batches in RAM and
                                   # reuse them (reference DataStore)
    cache_on_device: bool = False  # with cache_batches: cache the PLACED
                                   # batches so later epochs read from
                                   # device memory
    cache_compact: bool = False    # sorted backward on LocalStore: cache
                                   # the sort PERMUTATION only and derive
                                   # x_sorted/bidx/inv_sorted on the device
                                   # each step (learners/step.py ::
                                   # derive_sorted_slots); the same bits,
                                   # a third of the sorted arrays' bytes
    seed: int = 0

    def validate(self) -> None:
        assert self.batch_size > 0
        # <= 30: the padding sentinel is num_rows = 2**num_bits, which must
        # fit int32 with headroom (2**31 would wrap negative)
        assert 1 <= self.num_bits <= 30
        assert self.max_nnz_per_row > 0


@dataclass
class FMParam(ParamBase):
    """Model + optimizer knobs (reference: SGDUpdaterParam)."""

    # linear term w: FTRL-proximal (reference defaults)
    lr_eta: float = 0.01           # FTRL eta
    lr_beta: float = 1.0           # FTRL beta
    l1: float = 1.0                # L1 on w (drives exact sparsity)
    l2: float = 0.1                # L2 on w
    w_updater: str = "ftrl"        # ftrl | adagrad | sgd

    # latent factors V: AdaGrad, frequency-adaptive activation
    V_dim: int = 0                 # k; 0 = sparse logistic regression
    V_lr_eta: float = 0.01
    V_lr_beta: float = 1.0         # AdaGrad epsilon-ish damping
    V_l2: float = 0.0001
    V_init_scale: float = 0.01     # V ~ uniform(-scale, +scale)
    V_threshold: int = 2           # min feature count before V activates
    V_updater: str = "adagrad"     # adagrad | sgd

    tail_feature_filter: int = 0   # drop features with count < this (count pass)

    num_fields: int = 0            # loss=ffm: explicit field count F of
                                   # libffm data (0 = slot position is
                                   # the field, F = max_nnz_per_row)
    ffm_block_size: int = 0        # loss=ffm: stream the O(B L^2 K) cross
                                   # terms in i-blocks of this many slots;
                                   # 0 = dense when it fits the activation
                                   # cap, else picked at config time

    def validate(self) -> None:
        assert self.V_dim >= 0
        assert self.num_fields >= 0
        assert self.ffm_block_size >= 0
        assert self.w_updater in ("ftrl", "adagrad", "sgd")
        assert self.V_updater in ("adagrad", "sgd")


@dataclass
class LearnerParam(ParamBase):
    """Trainer driver knobs (reference: SGDLearnerParam)."""

    learner: str = "sgd"           # sgd | bcd
    loss: str = "fm"               # fm | logit | ffm | autoint
    task: str = "train"            # train | predict (predict needs model_in)
    pred_out: str = ""             # write raw margins here when task=predict
    max_num_epochs: int = 1
    model_out: str = ""            # checkpoint path prefix
    model_in: str = ""             # warm-start checkpoint
    report_interval: int = 100     # steps between progress reports
    save_interval_epochs: int = 1
    save_interval_steps: int = 0   # also checkpoint every N steps (0 = off);
                                   # resume skips the consumed batches
    exact_auc_cap: int = 4 << 20   # max host-collected (label, score) pairs
                                   # for the exact validation AUC; past it a
                                   # uniform reservoir sample of this many
                                   # pairs replaces the collection. 0
                                   # disables exact AUC.
    bcd_num_blocks: int = 256      # learner=bcd only
    bcd_tile_dir: str = ""         # learner=bcd only

    def validate(self) -> None:
        assert self.learner in ("sgd", "bcd")
        assert self.exact_auc_cap >= 0


@dataclass
class ShardParam(ParamBase):
    """Parallelism and kernel-path knobs."""

    store: str = "auto"            # local | sharded | auto (sharded
                                   # over more than one rank)
    num_shards: int = 0            # store=sharded only
    capacity_factor: float = 2.0   # store=sharded only
    unique_size: int = 0           # floor of the unique-lane bucket
    kernel: str = "auto"           # pairs = the unique-row table kernels
                                   # (ops/pair_sweep.py); pallas = the
                                   # whole-table sweep (ops/sweep.py); xla =
                                   # gathers and scatter-adds of tensor ops;
                                   # auto = xla with hot_rows,
                                   # host_localize=0 or layout=stacked,
                                   # else pairs
    layout: str = "auto"           # planar (w/z/n/cnt [N], V/nV [K, N]) |
                                   # packed (one row-major [N, 4+2K] table)
                                   # | stacked (one [4+2K, N] table;
                                   # kernel=xla only) | auto (see
                                   # parallel/store.py::_resolve_layout)
    block_rows: int = 1024         # table block of the sweep kernels
                                   # (kernel=pallas); must divide the rows
    segsum: str = "auto"           # sorted = the segment-sum kernel over the
                                   # host-sorted slot stream; scatter =
                                   # index_add_; auto = sorted for pairs
                                   # and xla, scatter for pallas
    interpret: bool = False        # Pallas interpret mode; no meaning here
    hot_rows: int = 0              # hot/cold table split: the hottest
                                   # hot_rows rows (by a count sample) in a
                                   # table of their own; -1 = auto-size
                                   # (data/remap.py); kernel=xla, stacked
    hot_count_batches: int = 16    # batches of the hot_rows count sample


@dataclass
class AutoIntParam(ParamBase):
    """loss=autoint (models/autoint.py): the interacting layers over the
    fields' d = ``V_dim`` embeddings and Adam on their dense weights
    (Song et al., CIKM 2019). Refused with any other loss."""

    attn_layers: int = 3           # interacting layers
    attn_heads: int = 2            # heads a layer
    attn_head_dim: int = 32        # d', the width of a head
    attn_residual: bool = True     # e <- ReLU(attention + W_Res e)
    dense_lr_eta: float = 0.001    # Adam on the dense weights
    dense_beta1: float = 0.9
    dense_beta2: float = 0.999
    dense_eps: float = 1e-8

    def __post_init__(self) -> None:
        self.given: list[str] = []

    def init(self, kwargs: KWArgs) -> KWArgs:
        names = {f.name for f in dataclasses.fields(self)}
        # the keys a config set, which another loss refuses
        self.given = [k for k, _ in kwargs if k in names]
        return super().init(kwargs)

    def validate(self) -> None:
        if not self.attn_residual:
            raise ValueError("attn_residual=0 is not implemented: the "
                             "published model has the residual projection")
        if min(self.attn_layers, self.attn_heads, self.attn_head_dim) < 1:
            raise ValueError("attn_layers, attn_heads and attn_head_dim must "
                             "be at least 1")
        if not (0.0 <= self.dense_beta1 < 1.0 and 0.0 <= self.dense_beta2 < 1.0
                and self.dense_lr_eta > 0.0 and self.dense_eps > 0.0):
            raise ValueError("Adam needs dense_lr_eta > 0, dense_eps > 0 and "
                             "betas in [0, 1)")


# the settings loss=autoint refuses (the store's step is the local, packed
# pairs path with host-prepped batches): (section, key, allowed values, why)
_AUTOINT_PATH = (
    ("shard", "store", ("auto", "local"),
     "the dense weights and their Adam state live on one card"),
    ("shard", "kernel", ("auto", "pairs"),
     "the sweep and the XLA path read no per-slot gradient payload"),
    ("shard", "layout", ("auto", "packed"),
     "its state is the row-major table with the dense part beside it"),
    ("shard", "hot_rows", (0,), "the split is a design of the XLA path"),
    ("learner", "learner", ("sgd",), "BCD trains linear and FM blocks"),
    ("data", "host_localize", (True,),
     "the fields go into field order from host-prepped batches"),
)


# loss=ffm activation cap in bytes: the JAX package's constant, kept so
# that both packages pick the same ffm_block_size (Config.check)
FFM_ACTIVATION_CAP = 8 << 30


@dataclass
class Config:
    data: DataParam = field(default_factory=DataParam)
    model: FMParam = field(default_factory=FMParam)
    learner: LearnerParam = field(default_factory=LearnerParam)
    shard: ShardParam = field(default_factory=ShardParam)

    def __post_init__(self) -> None:
        # not a field: dataclasses.fields(Config) are the JAX package's
        self.autoint = AutoIntParam()

    @classmethod
    def from_kwargs(cls, kwargs: KWArgs) -> "Config":
        cfg = cls()
        rest = kwargs
        for sub in (cfg.data, cfg.model, cfg.learner, cfg.shard, cfg.autoint):
            rest = sub.init(rest)
        if rest:
            raise ValueError(f"unknown config keys: {[k for k, _ in rest]}")
        cfg.check()
        return cfg

    def check(self) -> None:
        """Cross-param consistency, as the JAX package checks it, and the
        port's own refusal of ``kernel=pairs host_localize=0``."""
        if self.shard.hot_rows and self.learner.learner != "sgd":
            raise ValueError(
                "hot_rows (frequency-split table) is an SGD/LocalStore "
                "feature; BCD keeps its own block-tiled layout"
            )
        if self.shard.hot_rows and not self.data.host_localize:
            raise ValueError(
                "hot_rows needs host_localize=1 (the remap and the "
                "hot/cold bucket split are host-side prep work)"
            )
        if self.shard.kernel == "pairs" and not self.data.host_localize:
            # the JAX store trains such a config on its XLA ops, not on
            # the pair kernels it names (ROADMAP D)
            raise ValueError(
                "kernel=pairs needs host_localize=1 (the pair kernels read "
                "host-prepped batches); use kernel=xla or kernel=pallas "
                "with host_localize=0"
            )
        if self.shard.segsum not in ("auto", "sorted", "scatter"):
            raise ValueError(
                f"segsum must be auto|sorted|scatter, got {self.shard.segsum!r}"
            )
        if self.shard.kernel not in ("auto", "xla", "pallas", "pairs"):
            raise ValueError(f"unknown kernel {self.shard.kernel!r}")
        if self.shard.layout not in ("auto", "packed", "planar", "stacked"):
            raise ValueError(f"layout must be auto|packed|planar|stacked, "
                             f"got {self.shard.layout!r}")
        if self.shard.store not in ("auto", "local", "sharded"):
            raise ValueError(f"unknown store {self.shard.store!r}")
        if self.learner.loss not in ("fm", "logit", "ffm", "autoint"):
            raise ValueError(f"unknown loss {self.learner.loss!r}")
        if self.learner.loss == "autoint":
            self._check_autoint()
        elif self.autoint.given:
            raise ValueError(f"{self.autoint.given} are keys of loss=autoint, "
                             f"not of loss={self.learner.loss}")
        if self.model.num_fields > 0:
            if self.learner.loss not in ("ffm", "autoint"):
                # the JAX package's message (loss=autoint is the port's)
                raise ValueError("num_fields is only meaningful with loss=ffm")
            if self.data.data_format != "libffm":
                raise ValueError(
                    "num_fields > 0 needs data_format=libffm "
                    "(field:idx:val rows carry the field ids)"
                )
        if (
            self.learner.loss == "ffm"
            and self.data.data_format == "libffm"
            and self.model.num_fields == 0
        ):
            raise ValueError(
                "loss=ffm on libffm data needs num_fields=<field count> "
                "(with num_fields=0 the slot position is the field, which "
                "ignores the file's field ids)"
            )
        if self.learner.loss == "ffm" and self.model.V_dim > 0:
            self._check_ffm_activations()
        if self.shard.interpret:
            raise ValueError(
                "interpret=1 is a Pallas option; the port runs its kernels' "
                "plain versions whenever the tensors lie on the CPU"
            )

    def _check_autoint(self) -> None:
        """loss=autoint: libffm rows with their fields (the embeddings go
        into field order), factors, and the one path that trains it."""
        if self.data.data_format != "libffm" or self.model.num_fields <= 0:
            raise ValueError(
                "loss=autoint needs data_format=libffm and num_fields=<field "
                "count> (39 for Criteo): its output concatenates the fields' "
                "embeddings in field order")
        if self.model.V_dim <= 0:
            raise ValueError("loss=autoint needs V_dim > 0 (the embedding "
                             "width d)")
        for section, key, allowed, why in _AUTOINT_PATH:
            val = getattr(getattr(self, section), key)
            if val not in allowed:
                raise ValueError(
                    f"loss=autoint does not support {key}={val!r} (allowed: "
                    f"{'|'.join(str(a) for a in allowed)}): {why}")

    def _check_ffm_activations(self) -> None:
        """The FFM activation cap, the JAX package's rule kept for parity
        (``difacto_tpu/config.py:298-324``), so that both packages sum the
        cross terms in the same blocks: the dense loss holds ~6 [B, L, L, k]
        float32 tensors; past ``FFM_ACTIVATION_CAP`` bytes an unset
        ``ffm_block_size`` becomes the largest multiple of 8 whose ~3
        [B, block, L, k] tensors fit (at least 8). Unlike the JAX package,
        an explicit ``ffm_block_size`` is held to the same cap (dense when
        it is >= L, blocked below): a config over it fails here, not in
        the middle of an epoch."""
        B, L, k = (self.data.batch_size, self.data.max_nnz_per_row,
                   self.model.V_dim)
        cap = FFM_ACTIVATION_CAP
        dense = 6 * B * L * L * k * 4

        def blocked(blk):
            return 3 * B * blk * L * k * 4

        blk = self.model.ffm_block_size
        if blk:
            peak = dense if blk >= L else blocked(blk)
            if peak > cap:
                raise ValueError(
                    f"loss=ffm with ffm_block_size={blk}: activations "
                    f"~{peak / (1 << 30):.1f} GiB exceed the "
                    f"{cap >> 30} GiB cap (dense when the block is >= "
                    f"max_nnz_per_row {L}) — lower ffm_block_size, or set "
                    "0 to have one picked"
                )
            return
        if dense <= cap:
            return
        blk = max(8, cap // blocked(1) // 8 * 8)
        if blocked(blk) > cap:
            raise ValueError(
                f"loss=ffm activations ~{dense / (1 << 30):.1f} GiB "
                f"(6 * batch_size {B} * max_nnz_per_row^2 {L}^2 * "
                f"V_dim {k} * 4 B) exceed the {cap >> 30} GiB "
                "cap even blocked — lower batch_size or "
                "max_nnz_per_row (cost is O(B L^2 K))"
            )
        self.model.ffm_block_size = int(min(blk, L))

    def expects_fields(self) -> bool:
        """True when batches must carry explicit per-slot field ids."""
        return (self.learner.loss in ("ffm", "autoint")
                and self.model.num_fields > 0)

    def slot_grads(self) -> bool:
        """True when the loss gives each slot a gradient row of its own
        (FFM, AutoInt), which the sorted backward gathers by the sort
        permutation (``SortedSlots.slot_sorted``) into B3's payload."""
        return self.learner.loss in ("ffm", "autoint")

    def effective_model_param(self) -> FMParam:
        """The FMParam the updater and the table use. For loss=ffm a
        feature's factor payload is F*k wide (F = num_fields when set, else
        max_nnz_per_row: slot position is the field), in the same table."""
        p = dataclasses.replace(self.model)
        if self.learner.loss == "ffm":
            F = self.model.num_fields or self.data.max_nnz_per_row
            p.V_dim = self.model.V_dim * F
        return p
