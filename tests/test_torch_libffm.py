"""Explicit libffm fields and csr parts end to end: the port against the
JAX package on the CPU.

Slot-shuffled fields throughout (``make_ctr_data(with_fields=True,
shuffle_slots=True)``), so that a path that dropped the fields and fell
back to the slot position would fail. Same NumPy inputs and the same
start state through both packages: LocalStore steps on every table path
and layout against JAX's LocalStore with its Pallas kernels in interpret
mode, the field-range errors on the raw and the prepped path, the
learner on libffm text and on csr parts (cached on the device or not),
and checkpoints and predictions in both directions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from helpers import fm_leaves

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.batch_iter import Batch as JBatch
from difacto_tpu.data.prep import prep_batch as jprep_batch
from difacto_tpu.data.synthetic import make_ctr_data, write_libffm, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data import converter
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import prep_batch
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import FMUpdater, PackedFMState
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy

F, L, K_FFM, BITS = 5, 7, 2, 12


# -- LocalStore --------------------------------------------------------------


def _kw(extra=()):
    return [("batch_size", "96"), ("num_bits", str(BITS)),
            ("max_nnz_per_row", str(L)), ("V_dim", str(K_FFM)),
            ("loss", "ffm"), ("data_format", "libffm"),
            ("num_fields", str(F)), ("l1", "0.1"), ("lr_eta", "0.1"),
            ("V_lr_eta", "0.05"), ("V_threshold", "1"), *extra]


def _field_batch(seed, B=96, N=1 << BITS):
    """Rows of 3..L slots whose fields are drawn afresh per slot (so a
    field repeats within a row and is never the slot position), padding
    slots carrying id -1, value 0 and field 0 as BatchIter pads them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (B, L)).astype(np.int32)
    fields = rng.integers(0, F, (B, L)).astype(np.int32)
    lens = rng.integers(3, L + 1, B)
    pad = np.arange(L)[None, :] >= lens[:, None]
    ids[pad], fields[pad] = -1, 0
    vals = np.where(pad, 0, rng.normal(size=(B, L))).astype(np.float32)
    return (ids, vals, (rng.random(B) > 0.5).astype(np.float32),
            np.ones(B, np.float32), fields)


def _start_state(K, seed=7):
    rng = np.random.default_rng(seed)
    n = 1 << BITS
    return {"w": np.zeros(n, np.float32), "z": np.zeros(n, np.float32),
            "n": np.zeros(n, np.float32),
            "cnt": rng.integers(0, 3, n).astype(np.float32),
            "V": rng.uniform(-0.3, 0.3, (K, n)).astype(np.float32),
            "nV": np.zeros((K, n), np.float32)}


@pytest.mark.parametrize(
    "kernel,layout,segsum,block",
    [("pairs", "planar", "sorted", 0), ("pairs", "packed", "sorted", 0),
     ("pairs", "planar", "scatter", 0), ("pairs", "packed", "scatter", 0),
     ("pairs", "packed", "sorted", 3), ("pallas", "planar", "auto", 0),
     ("pallas", "packed", "auto", 0), ("pallas", "planar", "sorted", 0),
     ("pallas", "packed", "sorted", 0)],
)
def test_libffm_local_store_matches_jax(kernel, layout, segsum, block):
    """Three train steps with explicit, shuffled fields (F = 5 fields on
    L = 7 slots, so rows are F*k = 10 factors wide, not L*k), then an
    eval batch, on the pair kernels and the whole-table sweep, over both
    layouts, with the sorted and the scatter backward, dense and blocked,
    against JAX's LocalStore on the same path in interpret mode, from one
    NumPy state: leaves atol 2e-5 rtol 1e-5 (PR 7's FFM tolerance),
    logloss rtol 1e-5, margins atol 2e-5 rtol 1e-5, the AUC histogram
    equal."""
    N = 1 << BITS
    extra = [("kernel", kernel), ("segsum", segsum),
             ("ffm_block_size", str(block))]
    jcfg = JConfig.from_kwargs(_kw(extra))
    cfg = Config.from_kwargs(_kw(extra + [("layout", layout)]))
    p = cfg.effective_model_param()
    assert p.V_dim == jcfg.effective_model_param().V_dim == F * K_FFM
    jstore = JLocalStore(JFMUpdater(jcfg.effective_model_param()), jcfg,
                         interpret=True)
    store = LocalStore(FMUpdater(p), cfg, device="cpu")
    assert store.expects_fields and jstore.expects_fields
    assert (store.pallas, store.sorted_grads) == (jstore.pallas,
                                                 jstore.sorted_grads)
    s0 = _start_state(p.V_dim)
    jst = jstore.place_state(JFMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    assert isinstance(st, PackedFMState) == (layout == "packed")
    for s in range(3):
        b = _field_batch(s)
        jst, jm = jstore.train_step_prepped(
            jst, jprep_batch(JBatch(*b), N, num_fields=F))
        pb = prep_batch(Batch(*b), N, num_fields=F)
        assert pb.fields_checked and pb.fields is b[4]
        st, m = store.train_step_prepped(st, pb)
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
    ref, got = fm_leaves(jst), state_to_numpy(st)
    for name in ("w", "z", "n", "V", "nV", "cnt"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    b = _field_batch(9)
    jm, jpy = jstore.eval_step_prepped(
        jst, jprep_batch(JBatch(*b), N, num_fields=F))
    m, py = store.eval_step_prepped(st, prep_batch(Batch(*b), N,
                                                   num_fields=F))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(m.auc_hist.numpy(), np.asarray(jm.auc_hist))


def test_fields_are_read_not_the_slot_position():
    """The same batch with its fields replaced by the slot position gives
    other margins: the store reads the batch's fields."""
    N = 1 << BITS
    cfg = Config.from_kwargs(_kw())
    store = LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu")
    st = store.place_state(state_from_numpy(_start_state(F * K_FFM)))
    ids, vals, lab, mask, fields = _field_batch(4)
    slot = np.broadcast_to(np.arange(L) % F, ids.shape).astype(np.int32)
    _, a = store.eval_step_prepped(
        st, prep_batch(Batch(ids, vals, lab, mask, fields), N, num_fields=F))
    _, b = store.eval_step_prepped(
        st, prep_batch(Batch(ids, vals, lab, mask, slot), N, num_fields=F))
    assert not np.allclose(a.numpy(), b.numpy())


# -- field-range errors ------------------------------------------------------


def _stores():
    jcfg, cfg = JConfig.from_kwargs(_kw()), Config.from_kwargs(_kw())
    return (JLocalStore(JFMUpdater(jcfg.effective_model_param()), jcfg),
            LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu"))


@pytest.mark.parametrize("fields", ["out_of_range", "missing"])
def test_field_errors_on_the_raw_path_match_jax(fields):
    """``shard_batch`` of a raw batch raises JAX's ValueError for a field
    id >= num_fields and for a batch without fields."""
    ids, vals, lab, mask, f = _field_batch(1)
    f = np.full_like(f, F + 2) if fields == "out_of_range" else None
    jstore, store = _stores()
    with pytest.raises(ValueError) as ref:
        jstore.shard_batch(ids, vals, lab, mask, f)
    with pytest.raises(ValueError) as got:
        store.shard_batch(ids, vals, lab, mask, f)
    assert str(got.value) == str(ref.value)
    assert "out of range" in str(got.value) or "no field ids" in str(
        got.value)


@pytest.mark.parametrize("checked", [True, False])
def test_field_errors_on_the_prepped_path_match_jax(checked):
    """prep_batch(num_fields) raises JAX's ValueError on the host; a
    prepped batch that skipped the check (prepped without num_fields) is
    refused by the store's step, placed on the device first or not."""
    N = 1 << BITS
    ids, vals, lab, mask, f = _field_batch(2)
    f[3, 1] = F
    if checked:
        with pytest.raises(ValueError) as ref:
            jprep_batch(JBatch(ids, vals, lab, mask, f), N, num_fields=F)
        with pytest.raises(ValueError) as got:
            prep_batch(Batch(ids, vals, lab, mask, f), N, num_fields=F)
        assert str(got.value) == str(ref.value)
        return
    from difacto_tpu_torch.utils.place import place_batch

    _, store = _stores()
    st = store.init_state(0)
    pb = prep_batch(Batch(ids, vals, lab, mask, f), N)
    assert not pb.fields_checked
    for batch in (pb, place_batch(pb, store.device)):
        with pytest.raises(ValueError, match="out of range"):
            store.train_step_prepped(st, batch)
        with pytest.raises(ValueError, match="out of range"):
            store.eval_step_prepped(st, batch)


# -- the learner, checkpoints and predictions --------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Slot-shuffled libffm text (F = 5 fields on 5 slots), the same rows
    as libsvm text, and the libsvm text converted to csr parts by the
    port's converter."""
    d = tmp_path_factory.mktemp("libffm")
    for name, n, seed in (("train", 3000, 1), ("val", 1000, 2)):
        blk = make_ctr_data(n, num_fields=F, vocab_per_field=100, seed=seed,
                            with_fields=True, shuffle_slots=True)
        write_libffm(blk, str(d / f"{name}.ffm"))
        write_libsvm(blk, str(d / f"{name}.svm"))
        (d / f"{name}_parts").mkdir()
        converter.convert_file(str(d / f"{name}.svm"),
                               str(d / f"{name}_parts" / name), 700)
    return d


def _ffm_recipe(d, *extra):
    return [
        ("data_in", str(d / "train.ffm")), ("data_val", str(d / "val.ffm")),
        ("data_format", "libffm"), ("num_fields", str(F)),
        ("batch_size", "512"), ("num_bits", "13"), ("max_nnz_per_row", str(F)),
        ("V_dim", str(K_FFM)), ("loss", "ffm"), ("lr_eta", "0.1"),
        ("l1", "0.1"), ("V_lr_eta", "0.05"), ("max_num_epochs", "2"),
        ("store", "local"), *extra,
    ]


def _csr_recipe(d, *extra):
    return [
        ("data_in", str(d / "train_parts")), ("data_val", str(d / "val_parts")),
        ("data_format", "csr"), ("batch_size", "512"), ("num_bits", "13"),
        ("max_nnz_per_row", str(F)), ("V_dim", "4"), ("lr_eta", "0.1"),
        ("l1", "0.1"), ("V_lr_eta", "0.05"), ("max_num_epochs", "2"),
        ("store", "local"), *extra,
    ]


def _state(n, K, seed, trained=False):
    rng = np.random.default_rng(seed)
    s = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s["V"] = rng.uniform(-0.01, 0.01, (K, n)).astype(np.float32)
    s["nV"] = np.zeros((K, n), np.float32)
    if trained:
        s["w"] = (rng.normal(size=n) * (rng.random(n) < 0.3)).astype(
            np.float32)
        s["V"] = rng.normal(size=(K, n)).astype(np.float32) * 0.2
        s["cnt"] = rng.integers(0, 5, n).astype(np.float32)
    return s


@pytest.mark.parametrize("fmt,extra", [
    ("libffm", ()), ("libffm", (("layout", "planar"),)),
    ("libffm", (("cache_batches", "1"), ("cache_on_device", "1"),
                ("max_num_epochs", "3"))),
    ("libffm", (("kernel", "pallas"),)),
    ("csr", ()), ("csr", (("cache_batches", "1"), ("cache_on_device", "1"))),
], ids=["libffm", "libffm-planar", "libffm-cached", "libffm-pallas",
        "csr", "csr-cached"])
def test_recipe_matches_jax(data, tmp_path, fmt, extra):
    """A small recipe from one start state, the port's against the JAX
    learner on its default CPU path: FFM with explicit shuffled fields on
    libffm text (default path, planar leaves, batches replayed from the
    device cache in later epochs, the sweep path) and
    an FM on csr parts: validation logloss rel 1e-5, AUC abs 1e-5."""
    start = str(tmp_path / "start")
    K = F * K_FFM if fmt == "libffm" else 4
    jcheckpoint.save(start, JFMState(**_state(1 << 13, K, 3)), {"epoch": 0})
    mk = _ffm_recipe if fmt == "libffm" else _csr_recipe
    kw = mk(data, ("model_in", start))
    jextra = [e for e in extra if e[0] not in ("layout", "kernel")]
    jva = JSGDLearner(JConfig.from_kwargs(kw + jextra)).run()
    va = SGDLearner(Config.from_kwargs(kw + list(extra)), device="cpu").run()
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.55


def _predict(pkg, data, model, fmt, out=None):
    if fmt == "libffm":
        kw = _ffm_recipe(data, ("model_in", model))
        kw[0] = ("data_in", str(data / "val.ffm"))
    else:
        kw = _csr_recipe(data, ("model_in", model))
        kw[0] = ("data_in", str(data / "val_parts"))
    kw = [(k, v) for k, v in kw if k != "data_val"]
    if pkg == "jax":
        cfg = JConfig.from_kwargs(kw + [("max_num_epochs", "0")])
        return JSGDLearner(cfg).predict(cfg.data.data_in)[0]
    rc = cli.main([f"{k}={v}" for k, v in kw]
                  + ["task=predict", f"pred_out={out}"], device="cpu")
    assert rc == 0
    return np.loadtxt(out)


@pytest.mark.parametrize("fmt", ["libffm", "csr"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_predict_the_same_across_packages(data, tmp_path, fmt,
                                                      writer):
    """A checkpoint written by either package (the port's after a CLI
    training run on libffm text or csr parts, JAX's from a trained-looking
    state) scores the same through both packages' predict on the same
    data (pred_out keeps 6 significant digits: rtol 2e-5, atol 1e-5)."""
    model = str(tmp_path / "model")
    K = F * K_FFM if fmt == "libffm" else 4
    if writer == "port":
        mk = _ffm_recipe if fmt == "libffm" else _csr_recipe
        kw = [(k, v) for k, v in mk(data, ("model_out", model),
                                    ("max_num_epochs", "1"))]
        assert cli.main([f"{k}={v}" for k, v in kw], device="cpu") == 0
    else:
        jcheckpoint.save(model, JFMState(**{
            k: jnp.asarray(v)
            for k, v in _state(1 << 13, K, 4, trained=True).items()
        }), {"epoch": 2})
    host, _ = jcheckpoint.load(model)
    assert host.V.shape == (K, 1 << 13)
    ref = _predict("jax", data, model, fmt)
    got = _predict("port", data, model, fmt, tmp_path / "pred.txt")
    assert got.shape == ref.shape == (1000,)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_csr_parts_train_as_their_text(data, tmp_path):
    """The port on one csr part of each file and on the libsvm text it
    came from: the same batches, so the same validation metrics, bit for
    bit."""
    for name in ("train", "val"):
        converter.convert_file(str(data / f"{name}.svm"),
                               str(tmp_path / name))
    kw = _csr_recipe(data, ("shuffle", "0"))
    parts = [("data_in", str(tmp_path / "train.part00000.npz")),
             ("data_val", str(tmp_path / "val.part00000.npz"))]
    txt = [("data_in", str(data / "train.svm")),
           ("data_val", str(data / "val.svm")), ("data_format", "libsvm")]
    a = SGDLearner(Config.from_kwargs(kw + parts), device="cpu").run()
    b = SGDLearner(Config.from_kwargs(kw + txt), device="cpu").run()
    assert a.num_examples == b.num_examples == 1000
    assert a.logloss == b.logloss and a.exact_auc == b.exact_auc
