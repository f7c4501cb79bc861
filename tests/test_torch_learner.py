"""The port's learner, CLI and checkpoints against the JAX package, its
config guard, and its isolation from JAX.

The verify recipe (synthetic CTR data, batch 512, 2^16 rows, K = 8)
trains under both packages from one start state — a checkpoint both load
with ``model_in`` — and their validation metrics must agree. Checkpoints
cross between the packages in both directions and score the same through
``task=predict``.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data import libsvm as jlibsvm
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters import updater as jupd
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data import libsvm, synthetic
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.parallel.store import make_store
from difacto_tpu_torch.updaters.updater import (FMState, FMUpdater,
                                                PackedFMState)
from difacto_tpu_torch.utils import checkpoint
from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                state_to_numpy)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BITS, K = 16, 8


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctr")
    write_libsvm(make_ctr_data(8000, num_fields=10, vocab_per_field=300,
                               seed=1), str(d / "train.svm"))
    write_libsvm(make_ctr_data(2000, num_fields=10, vocab_per_field=300,
                               seed=2), str(d / "val.svm"))
    return d


def test_synthetic_data_and_parser_match_jax(data):
    """The port's generator, libsvm writer and parser give the JAX
    package's bytes and arrays (chip_smoke.py draws its CLI data with the
    port's copy)."""
    ref = make_ctr_data(500, num_fields=10, vocab_per_field=300, seed=2)
    got = synthetic.make_ctr_data(500, num_fields=10, vocab_per_field=300,
                                  seed=2)
    for name in ("labels", "indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    raw = (data / "val.svm").read_bytes()
    out = data / "port_val.svm"
    synthetic.write_libsvm(synthetic.make_ctr_data(
        2000, num_fields=10, vocab_per_field=300, seed=2), str(out))
    assert out.read_bytes() == raw
    a, b = jlibsvm.parse_libsvm(raw), libsvm.parse_libsvm(raw)
    for name in ("labels", "indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))


def _recipe(d, *extra):
    return [
        ("data_in", str(d / "train.svm")), ("data_val", str(d / "val.svm")),
        ("batch_size", "512"), ("num_bits", str(BITS)),
        ("max_nnz_per_row", "12"), ("V_dim", str(K)), ("lr_eta", "0.1"),
        ("l1", "0.1"), ("V_lr_eta", "0.05"), ("max_num_epochs", "2"),
        ("store", "local"), *extra,
    ]


def _random_state(seed, trained=False):
    rng = np.random.default_rng(seed)
    n = 1 << BITS
    s = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s["V"] = rng.uniform(-0.01, 0.01, (K, n)).astype(np.float32)
    s["nV"] = np.zeros((K, n), np.float32)
    if trained:
        s["w"] = (rng.normal(size=n) * (rng.random(n) < 0.3)).astype(
            np.float32)
        s["V"] = rng.normal(size=(K, n)).astype(np.float32) * 0.2
        s["cnt"] = rng.integers(0, 5, n).astype(np.float32)
    return s


def test_verify_recipe_matches_jax(data, tmp_path):
    """Two epochs from one start state. Both train on the same batches in
    the same order; per-key sums differ by float association only (the
    sorted segment sum against JAX's scatter-add), which 32 steps of
    FTRL/AdaGrad keep far below the stated tolerances."""
    start = str(tmp_path / "start")
    jcheckpoint.save(start, JFMState(**_random_state(3)), {"epoch": 0})
    kw = _recipe(data, ("model_in", start))
    jva = JSGDLearner(JConfig.from_kwargs(kw)).run()
    va = SGDLearner(Config.from_kwargs(kw), device="cpu").run()
    assert va.num_examples == jva.num_examples == 2000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.6


def test_verify_recipe_pallas_matches_jax(data, tmp_path):
    """The whole-table sweep path (kernel=pallas: B4, the scatter
    backward, B5) trains the verify recipe as the JAX learner does on the
    same path (its Pallas kernels in interpret mode), and the CLI scores
    the result with kernel=pallas as JAX's predict does."""
    start, model = str(tmp_path / "start"), str(tmp_path / "model")
    jcheckpoint.save(start, JFMState(**_random_state(3)), {"epoch": 0})
    kw = _recipe(data, ("model_in", start), ("kernel", "pallas"))
    jva = JSGDLearner(JConfig.from_kwargs(kw + [("interpret", "1")])).run()
    va = SGDLearner(Config.from_kwargs(kw + [("model_out", model)]),
                    device="cpu").run()
    assert va.num_examples == jva.num_examples == 2000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.6
    got = _predict_port(data, model, tmp_path / "pred.txt", "kernel=pallas")
    np.testing.assert_allclose(got, _predict_jax(data, model), rtol=2e-5,
                               atol=1e-5)


def test_verify_recipe_packed_matches_jax(data, tmp_path):
    """``layout=packed`` (the row-major table on the pairs path) trains
    the verify recipe as the JAX learner does with ``layout=packed
    kernel=xla`` (logloss rel 1e-5, AUC abs 1e-5) and to the bits of the
    port's ``layout=planar``; its checkpoint is the planar interchange
    format, which ``task=predict`` scores the same in either layout and
    in the JAX package."""
    start, model = str(tmp_path / "start"), str(tmp_path / "model")
    jcheckpoint.save(start, JFMState(**_random_state(3)), {"epoch": 0})
    kw = _recipe(data, ("model_in", start), ("layout", "packed"))
    jva = JSGDLearner(JConfig.from_kwargs(kw + [("kernel", "xla")])).run()
    learner = SGDLearner(Config.from_kwargs(kw + [("model_out", model)]),
                         device="cpu")
    assert isinstance(learner.state, PackedFMState)
    va = learner.run()
    assert va.num_examples == jva.num_examples == 2000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.6
    planar = SGDLearner(Config.from_kwargs(_recipe(
        data, ("model_in", start), ("layout", "planar"))), device="cpu")
    assert isinstance(planar.state, FMState)
    vp = planar.run()
    assert (vp.logloss, vp.exact_auc) == (va.logloss, va.exact_auc)
    host, meta = jcheckpoint.load(model)  # planar leaves on disk
    assert host.V.shape == (K, 1 << BITS) and meta["epoch"] == 2
    ref = _predict_jax(data, model)
    for layout in ("packed", "planar"):
        got = _predict_port(data, model, tmp_path / f"pred_{layout}.txt",
                            f"layout={layout}")
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_checkpoints_cross_layouts_and_packages(data, tmp_path):
    """packed -> planar -> packed in the port, and port <-> JAX: a model
    is written as planar leaves whatever the run's layout and loads into
    a store of either layout, in both packages, with the same floats."""
    s = _random_state(6, trained=True)
    cfgs = {lay: Config.from_kwargs(_recipe(data, ("layout", lay)))
            for lay in ("packed", "planar")}
    stores = {lay: make_store(FMUpdater(c.model), c, device="cpu")
              for lay, c in cfgs.items()}
    packed = stores["packed"].place_state(state_from_numpy(s))
    assert isinstance(packed, PackedFMState)
    a = str(tmp_path / "from_packed")
    checkpoint.save(a, packed, {"epoch": 1})
    planar, meta = checkpoint.load_for_store(a, stores["planar"])
    assert isinstance(planar, FMState) and meta["epoch"] == 1
    b = str(tmp_path / "from_planar")
    checkpoint.save(b, planar, {"epoch": 1})
    again, _ = checkpoint.load_for_store(b, stores["packed"])
    assert isinstance(again, PackedFMState)
    assert torch.equal(again.tbl, packed.tbl)
    for name, v in state_to_numpy(again).items():
        np.testing.assert_array_equal(v, s[name], err_msg=name)
    # the JAX package reads the port's file into its packed store, and the
    # port carries JAX's table back in
    jlearner = JSGDLearner(JConfig.from_kwargs(
        _recipe(data, ("layout", "packed"), ("kernel", "xla"),
                ("model_in", a))))
    assert isinstance(jlearner.state, jupd.PackedFMState)
    np.testing.assert_array_equal(np.asarray(jlearner.state.tbl),
                                  packed.tbl.numpy())
    back = state_from_numpy(jlearner.state, layout="packed")
    assert torch.equal(back.tbl, packed.tbl)
    # and JAX's file, saved from its packed state, loads into either store
    c = str(tmp_path / "from_jax")
    jcheckpoint.save(c, jlearner.state, {"epoch": 1})
    for lay, store in stores.items():
        st, _ = checkpoint.load_for_store(c, store)
        for name, v in state_to_numpy(st).items():
            np.testing.assert_array_equal(v, s[name], err_msg=f"{lay} {name}")


@pytest.mark.parametrize(
    "kw,layout",
    [
        ((("layout", "packed"),), "packed"),
        ((("layout", "packed"), ("kernel", "pairs")), "packed"),
        ((("layout", "packed"), ("V_dim", "0")), "packed"),
        ((("layout", "planar"),), "planar"),
        ((), "packed"),                       # auto, an FM on the pairs path
        ((("kernel", "pairs"),), "packed"),
        ((("V_dim", "0"),), "planar"),        # auto without factors
        ((("kernel", "pallas"),), "packed"),  # auto, an FM on the sweep path
        ((("kernel", "pallas"), ("layout", "planar")), "planar"),
        ((("kernel", "pallas"), ("layout", "packed")), "packed"),
        ((("kernel", "pallas"), ("V_dim", "0")), "packed"),
    ],
)
def test_layout_resolves_as_measured(kw, layout):
    """``layout=packed`` is in the port on both table paths; ``auto`` takes
    it where every row-major kernel measured no slower than its planar
    counterpart (the sweep path; the pairs path with factors)."""
    base = {"num_bits": "12", "V_dim": "4", **dict(kw)}
    cfg = Config.from_kwargs(list(base.items()))
    store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.layout == layout
    st = store.init_state(1)
    assert isinstance(st, PackedFMState if layout == "packed" else FMState)
    assert st.num_rows == 1 << 12 and st.k == cfg.model.V_dim


_PALLAS_PACKED = [("num_bits", "12"), ("kernel", "pallas"),
                  ("layout", "packed")]


@pytest.mark.parametrize("layout", ["packed", "stacked"])
def test_stacked_raises_and_the_jax_store_refuses_packed_with_sweeps(layout):
    """What raises with the sweep kernels: ``stacked`` in both packages'
    stores (the XLA path's table; the JAX store's ValueError), and
    ``packed`` in the JAX store (XLA's lane padding on the TPU). The
    port's store takes ``packed``: the next test."""
    if layout == "stacked":
        kw = _PALLAS_PACKED[:2] + [("layout", layout)]
        cfg, jcfg = Config.from_kwargs(kw), JConfig.from_kwargs(kw)
        with pytest.raises(ValueError, match="incompatible with kernel="
                           "'pallas'"):
            make_store(FMUpdater(cfg.model), cfg, device="cpu")
        with pytest.raises(ValueError, match="incompatible with kernel="
                           "'pallas'"):
            JLocalStore(JFMUpdater(jcfg.model), jcfg, interpret=True)
        return
    jcfg = JConfig.from_kwargs(_PALLAS_PACKED)
    with pytest.raises(ValueError, match="incompatible with kernel='pallas'"):
        JLocalStore(JFMUpdater(jcfg.model), jcfg, interpret=True)


def test_layout_packed_with_the_sweep_kernels_builds_a_packed_store():
    """Since the sweep kernels have their row-major design
    (csrc/rowmajor_sweep.cu) the store runs them over the row-major
    table."""
    cfg = Config.from_kwargs(_PALLAS_PACKED)
    store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.layout == "packed" and store.pallas
    assert isinstance(SGDLearner(cfg, device="cpu").state, PackedFMState)


@pytest.mark.parametrize("segsum", ["scatter", "sorted"])
def test_verify_recipe_pallas_packed_matches_jax(data, tmp_path, segsum):
    """``kernel=pallas layout=packed`` (the sweep over the row-major
    table) trains the verify recipe as the JAX learner does on
    ``kernel=pallas`` (planar, its Pallas kernels in interpret mode;
    logloss rel 1e-5, AUC abs 1e-5) and to the bits of the port's
    ``kernel=pallas layout=planar``; ``task=predict`` scores its planar
    checkpoint the same on either layout and in the JAX package."""
    start, model = str(tmp_path / "start"), str(tmp_path / "model")
    jcheckpoint.save(start, JFMState(**_random_state(3)), {"epoch": 0})
    kw = _recipe(data, ("model_in", start), ("kernel", "pallas"),
                 ("segsum", segsum))
    jva = JSGDLearner(JConfig.from_kwargs(kw + [("interpret", "1")])).run()
    learner = SGDLearner(Config.from_kwargs(
        kw + [("layout", "packed"), ("model_out", model)]), device="cpu")
    assert isinstance(learner.state, PackedFMState) and learner.store.pallas
    va = learner.run()
    assert va.num_examples == jva.num_examples == 2000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.6
    planar = SGDLearner(Config.from_kwargs(kw + [("layout", "planar")]),
                        device="cpu")
    assert isinstance(planar.state, FMState)
    vp = planar.run()
    assert (vp.logloss, vp.exact_auc) == (va.logloss, va.exact_auc)
    ref = _predict_jax(data, model)
    for layout in ("packed", "planar"):
        got = _predict_port(data, model, tmp_path / f"pred_{layout}.txt",
                            "kernel=pallas", f"layout={layout}")
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_save_interval_resume_pallas_across_layouts(data, tmp_path):
    """``save_interval_steps`` resume on ``kernel=pallas``: saved from the
    row-major table, resumed into either layout, the interrupted epoch
    ends in the same floats."""
    out = str(tmp_path / "mid")
    kw = _recipe(data, ("model_out", out), ("save_interval_steps", "5"),
                 ("kernel", "pallas"), ("layout", "packed"))
    full = SGDLearner(Config.from_kwargs(kw), device="cpu")
    assert isinstance(full.state, PackedFMState)
    full.train_epoch(0)
    meta = checkpoint._read_meta(out)
    assert (meta["epoch"], meta["step"]) == (0, 15)
    a = state_to_numpy(full.state)
    for layout in ("packed", "planar"):
        resumed = SGDLearner(Config.from_kwargs(_recipe(
            data, ("model_in", out), ("kernel", "pallas"),
            ("layout", layout))), device="cpu")
        resumed.train_epoch(0)  # skips the 15 consumed batches
        b = state_to_numpy(resumed.state)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{layout} {name}")


def test_save_interval_resume_packed_matches_uninterrupted(data, tmp_path):
    """``save_interval_steps`` resume with ``layout=packed``, and into a
    planar store: the interrupted epoch ends in the same floats."""
    out = str(tmp_path / "mid")
    kw = _recipe(data, ("model_out", out), ("save_interval_steps", "5"),
                 ("layout", "packed"))
    full = SGDLearner(Config.from_kwargs(kw), device="cpu")
    full.train_epoch(0)
    meta = checkpoint._read_meta(out)
    assert (meta["epoch"], meta["step"]) == (0, 15)
    a = state_to_numpy(full.state)
    for layout in ("packed", "planar"):
        resumed = SGDLearner(Config.from_kwargs(_recipe(
            data, ("model_in", out), ("layout", layout))), device="cpu")
        resumed.train_epoch(0)  # skips the 15 consumed batches
        b = state_to_numpy(resumed.state)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{layout} {name}")


def test_save_interval_resume_matches_uninterrupted(data, tmp_path):
    out = str(tmp_path / "mid")
    kw = _recipe(data, ("model_out", out), ("save_interval_steps", "5"))
    full = SGDLearner(Config.from_kwargs(kw), device="cpu")
    full.train_epoch(0)  # 16 steps: the last step-save is at step 15
    meta = checkpoint._read_meta(out)
    assert (meta["epoch"], meta["step"]) == (0, 15)
    resumed = SGDLearner(Config.from_kwargs(
        _recipe(data, ("model_in", out))), device="cpu")
    resumed.train_epoch(0)  # skips the 15 consumed batches
    a, b = state_to_numpy(full.state), state_to_numpy(resumed.state)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _predict_port(data, model, out, *extra):
    cli.main([f"data_in={data / 'val.svm'}", "batch_size=512",
              f"num_bits={BITS}", "max_nnz_per_row=12", f"V_dim={K}",
              "task=predict", f"model_in={model}", f"pred_out={out}",
              *extra], device="cpu")
    return np.loadtxt(out)


def _predict_jax(data, model):
    cfg = JConfig.from_kwargs([
        ("data_in", str(data / "val.svm")), ("batch_size", "512"),
        ("num_bits", str(BITS)), ("max_nnz_per_row", "12"),
        ("V_dim", str(K)), ("model_in", model), ("max_num_epochs", "0"),
        ("store", "local"),
    ])
    py, _ = JSGDLearner(cfg).predict(str(data / "val.svm"))
    return py


def test_jax_checkpoint_predicts_the_same_in_the_port(data, tmp_path):
    model = str(tmp_path / "jax_model")
    jcheckpoint.save(model, JFMState(**{
        k: jnp.asarray(v) for k, v in _random_state(4, trained=True).items()
    }), {"epoch": 2})
    ref = _predict_jax(data, model)
    got = _predict_port(data, model, tmp_path / "pred.txt")
    assert got.shape == ref.shape == (2000,)
    # pred_out keeps 6 significant digits
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_port_checkpoint_predicts_the_same_in_jax(data, tmp_path):
    model = str(tmp_path / "port_model")
    kw = _recipe(data, ("model_out", model), ("max_num_epochs", "1"))
    SGDLearner(Config.from_kwargs(kw), device="cpu").run()
    host, meta = jcheckpoint.load(model)  # the JAX package reads it
    assert meta["format_version"] == 1 and meta["epoch"] == 1
    assert host.V.shape == (K, 1 << BITS)
    got = _predict_port(data, model, tmp_path / "pred.txt")
    ref = _predict_jax(data, model)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_config_keys_and_defaults_match_jax():
    def defaults(cfg):
        return {f.name: getattr(getattr(cfg, part.name), f.name)
                for part in dataclasses.fields(cfg)
                for f in dataclasses.fields(getattr(cfg, part.name))}

    assert defaults(Config()) == defaults(JConfig())


def test_unknown_key_is_fatal():
    with pytest.raises(ValueError, match="unknown config keys"):
        Config.from_kwargs([("V_dim", "4"), ("no_such_key", "1")])


_OUT_OF_SLICE = [
    ("store", "sharded", "A9", ()),
    ("learner", "bcd", "A15", ()),
    ("hot_rows", "1024", "A13", ()),
    ("kernel", "xla", "A14", ()),
    ("layout", "stacked", "A14", ()),
    ("pred_out", "hdfs://host/pred", "A19", ()),
    ("host_localize", "0", "A16", ()),
    ("data_in", "s3://bucket/train", "A19", ()),
    ("model_out", "gs://bucket/model", "A19", ()),
]


# the cases of ROADMAP items the port has brought since: (kernel, layout)
# each resolves to, as the JAX store resolves it; A9 (store=sharded, A9a)
# gives a ShardedStore of one shard on the pairs path
_PORTED = {"A13": ("xla", "stacked"), "A14": ("xla", "stacked"),
           "A16": ("xla", "stacked"), "A9": ("pairs", "planar")}
# items ported since that configure no store: the BCD learner, remote IO
_ACCEPTED = ("A15", "A19")


@pytest.mark.parametrize("key,val,item,extra", _OUT_OF_SLICE,
                         ids=[f"{k}-{v}-{i}" for k, v, i, _ in _OUT_OF_SLICE])
def test_out_of_slice_setting_raises(key, val, item, extra):
    """A setting outside the port raises, naming its ROADMAP item; one of
    an item ported since (A13 hot/cold, A14 the XLA path, A16 device
    localize, A9 the sharded store) is accepted and resolves as the JAX
    store resolves it (the sharded store to one shard); one
    of A15 (BCD) or A19 (remote IO) is accepted and parses as in the JAX
    package."""
    kw = [("num_bits", "12"), (key, val), *extra]
    if item in _ACCEPTED:
        cfg, jcfg = Config.from_kwargs(kw), JConfig.from_kwargs(kw)
        sub = "data" if key.startswith("data") else "learner"
        assert getattr(getattr(cfg, sub), key) == val
        assert getattr(getattr(jcfg, sub), key) == val
        return
    if item not in _PORTED:
        with pytest.raises(NotImplementedError, match=item):
            Config.from_kwargs(kw)
        return
    cfg, jcfg = Config.from_kwargs(kw), JConfig.from_kwargs(kw)
    store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
    assert (store.kernel, store.layout) == _PORTED[item]
    if item == "A9":
        from difacto_tpu_torch.parallel.store import ShardedStore

        # one process: one shard, the table of the hash space
        assert isinstance(store, ShardedStore) and store.S == 1
        assert store.num_rows == 1 << 12
        return
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg)
    assert not (jstore.pairs or jstore.pallas)  # the JAX store's xla
    assert jstore.layout == store.layout
    assert store.hot_rows == jstore.hot_rows
    assert store.sorted_grads


@pytest.mark.parametrize(
    "kw,pallas,sorted_grads",
    [
        ((("kernel", "pallas"),), True, False),
        ((("segsum", "scatter"),), False, False),
    ],
)
def test_kernel_settings_are_accepted(kw, pallas, sorted_grads):
    """kernel=pallas and segsum=scatter are in the port (they raised
    before the whole-table sweep came); segsum=auto is sorted on pairs
    and scatter on pallas, as the JAX store resolves it."""
    cfg = Config.from_kwargs([("num_bits", "12"), *kw])
    store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
    assert (store.pallas, store.sorted_grads) == (pallas, sorted_grads)


@pytest.mark.parametrize(
    "kw,fmt,expects_fields",
    [
        ((("loss", "ffm"), ("data_format", "libffm"), ("num_fields", "4")),
         "libffm", True),
        ((("data_format", "libffm"),), "libffm", False),
        ((("data_format", "csr"),), "csr", False),
    ],
    ids=["ffm-libffm-num_fields", "libffm", "csr"],
)
def test_data_settings_are_accepted(kw, fmt, expects_fields):
    """data_format=libffm|csr and num_fields are in the port (they raised
    before the data formats came); the store reads explicit fields only
    when the config declares them (loss=ffm with num_fields > 0)."""
    cfg = Config.from_kwargs([("num_bits", "12"), *kw])
    store = make_store(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu")
    assert cfg.data.data_format == fmt
    assert store.expects_fields == cfg.expects_fields() == expects_fields


def test_entry_points_need_a_card_unless_asked_for_cpu(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = Config.from_kwargs(_recipe(data))
    with pytest.raises(RuntimeError, match="CUDA"):
        SGDLearner(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([f"data_in={data / 'train.svm'}", "num_bits=12"])


_ISOLATION = """
import sys
import numpy as np
import torch
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import prep_batch
from difacto_tpu_torch.parallel.store import make_store
from difacto_tpu_torch.updaters.updater import FMUpdater
from difacto_tpu_torch.data import _native, converter, libsvm
import difacto_tpu_torch.cli, difacto_tpu_torch.learners.sgd
from difacto_tpu_torch.probes import (bench_slot_accum, bisect_apply,
                                      hw_apply2, hw_packed_pairs,
                                      segsum_designs)
cfg = Config.from_kwargs([("batch_size", "8"), ("num_bits", "10"),
                          ("max_nnz_per_row", "4"), ("V_dim", "2")])
store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
rng = np.random.default_rng(0)
b = Batch(rng.integers(0, 1024, (8, 4)).astype(np.int32),
          np.ones((8, 4), np.float32), np.ones(8, np.float32),
          np.ones(8, np.float32))
st, m = store.train_step_prepped(store.init_state(0), prep_batch(b, 1024))
assert float(m.examples) == 8.0
from difacto_tpu_torch.data import remap, tile_store
import difacto_tpu_torch.learners.bcd
from difacto_tpu_torch.tools import dump_model, table_stats
from difacto_tpu_torch.utils import tracing
kw = [("batch_size", "8"), ("num_bits", "10"), ("max_nnz_per_row", "4"),
      ("V_dim", "2")]
cfg = Config.from_kwargs(kw + [("hot_rows", "64")])
hot = make_store(FMUpdater(cfg.model), cfg, device="cpu")
lut = remap.build_remap(remap.count_sample(iter([b]), 1024, 1), 64)
hot.set_remap(lut)
st, m = hot.train_step_prepped(hot.init_state(0), prep_batch(
    b, 1024, remap=lut, hot_rows=64))
cfg = Config.from_kwargs(kw + [("host_localize", "0")])
dev = make_store(FMUpdater(cfg.model), cfg, device="cpu")
st, m = dev.train_step(dev.init_state(0), b.ids, b.vals, b.labels, b.mask)
assert float(m.examples) == 8.0 and float(m.dropped_ids) == 0.0
from difacto_tpu_torch.data.prep import prep_batch_sharded
from difacto_tpu_torch.parallel import launch, multihost
cfg = Config.from_kwargs(kw + [("store", "sharded")])
sh = make_store(FMUpdater(cfg.model), cfg, device="cpu")
st, m = sh.train_step_prepped(sh.init_state(0), prep_batch_sharded(b, 1024, 1))
assert float(m.examples) == 8.0 and not multihost.multiprocess_requested()
blk = libsvm.parse_libsvm(b"1 3:1 5:2\\n0 4:1\\n")
assert blk.num_rows == 2 and sum(_native.RUNS.values()) == 1
assert libsvm.parse_libffm(b"1 0:3:1\\n").fields.tolist() == [0]
small = ["batch=64", "nnz=4", "num_bits=10", "k=2", "iters=1"]
assert hw_apply2.main(small + ["u=512"], device="cpu") == 0
assert hw_packed_pairs.main(small, device="cpu") == 0
assert bisect_apply.main(["ftrl4", "n_log2=10", "u=50"], device="cpu") == 0
assert bench_slot_accum.main(["8", "rows=8"], device="cpu") == 0
assert segsum_designs.main(["batch=64", "nnz=4", "num_bits=10", "pp=4"],
                           device="cpu") == 0
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "difacto_tpu"
             or n.startswith("difacto_tpu.") or n == "bench")
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    r = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_import_no_jax():
    """Static scan: no ``import jax``, no import of ``difacto_tpu``
    (absolute, or relative past the package root) and none of the JAX
    package's root ``bench.py`` in the port's sources (the probes
    included), nor in chip_smoke.py."""
    files = list((ROOT / "difacto_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                depth = len(path.relative_to(ROOT).parts) - 1
                assert node.level <= depth, f"{path}: relative import leaves the package"
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "difacto_tpu", "bench"), \
                    f"{path} imports {n}"
