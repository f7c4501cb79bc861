"""The port's hot/cold split (``hot_rows``, ``HotColdFMState`` and
data/remap.py) against the JAX package.

Mirrors tests/test_hotcold.py across the packages: the remap lut and the
split prep arrays equal JAX's exactly (the NumPy and the native
localizer); split train steps from one canonical state hold every leaf
within rel 1e-5 / abs 1e-6 of JAX's split store (``kernel=xla``, its
segment sum in interpret mode for ``segsum=sorted``) and train as the
port's own stacked table does; checkpoints are canonical and load into
either package; the learner builds the same remap and trains within
logloss rel 1e-5 and AUC abs 1e-5 of the JAX learner.
"""

import jax
import numpy as np
import pytest
import torch

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data import remap as jremap
from difacto_tpu.data.batch_iter import Batch as JBatch
from difacto_tpu.data.prep import build_sorted_slots as jbuild_sorted_slots
from difacto_tpu.data.prep import prep_batch as jprep_batch
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters import updater as jupd
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data import _native, remap
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import FMUpdater, HotColdFMState
from difacto_tpu_torch.utils import checkpoint
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

NB, H = 12, 512
N = 1 << NB
LEAVES = ("w", "z", "n", "V", "nV", "cnt")
TOL = dict(rtol=1e-5, atol=1e-6)    # leaves
PY_TOL = dict(rtol=1e-5, atol=2e-5)  # margins


def _kw(hot, K=4, **kv):
    return [("batch_size", "256"), ("num_bits", str(NB)),
            ("max_nnz_per_row", "10"), ("V_dim", str(K)), ("kernel", "xla"),
            ("store", "local"), ("hot_rows", str(hot)), ("l1", "0.1"),
            ("lr_eta", "0.1"), ("V_lr_eta", "0.05"),
            *((k, str(v)) for k, v in kv.items())]


def _batch(seed, B=256, L=10, n=N):
    r = np.random.default_rng(seed)
    ids = (r.zipf(1.3, (B, L)) % n).astype(np.int32)
    ids[r.random(ids.shape) < 0.1] = -1
    vals = np.where(ids >= 0, r.normal(size=ids.shape), 0.0).astype(
        np.float32)
    return Batch(ids, vals, (r.random(B) > 0.5).astype(np.float32),
                 np.ones(B, np.float32))


def _jbatch(b):
    return JBatch(b.ids, b.vals, b.labels, b.mask)


def _state(K=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=N).astype(np.float32) * 0.1,
            "z": rng.normal(size=N).astype(np.float32),
            "n": np.abs(rng.normal(size=N)).astype(np.float32),
            "V": rng.normal(size=(K, N)).astype(np.float32) * 0.1,
            "nV": np.abs(rng.normal(size=(K, N))).astype(np.float32),
            "cnt": rng.integers(0, 5, N).astype(np.float32)}


def _lut(n=N, h=H, batches=4):
    bs = [_batch(i, n=n) for i in range(batches)]
    return bs, remap.build_remap(remap.count_sample(iter(bs), n, batches), h)


@pytest.mark.parametrize("n,h,batches", [(N, H, 4), (N, 64, 1),
                                         (1 << 16, 1 << 12, 3)])
def test_remap_matches_jax(n, h, batches):
    """The lut of a count sample, its inverse and a relabeled batch: the
    JAX package's arrays exactly."""
    bs, lut = _lut(n, h, batches)
    ref = jremap.build_remap(jremap.count_sample(iter(bs), n, batches), h)
    np.testing.assert_array_equal(lut, ref)
    assert lut.dtype == ref.dtype
    np.testing.assert_array_equal(remap.invert_remap(lut),
                                  jremap.invert_remap(ref))
    np.testing.assert_array_equal(remap.apply_remap(bs[0].ids, lut),
                                  jremap.apply_remap(bs[0].ids, ref))
    np.testing.assert_array_equal(remap.count_sample(iter(bs), n, 2),
                                  jremap.count_sample(iter(bs), n, 2))


@pytest.mark.parametrize("n,k", [(1 << 26, 16), (1 << 26, 64), (1 << 12, 16),
                                 (1 << 22, 96), (1 << 30, 0)])
def test_auto_hot_rows_matches_jax(n, k):
    """Both packages choose the same hot table (the JAX package's 48 MB
    budget: 2^18 rows at K = 16)."""
    assert remap.auto_hot_rows(n, k) == jremap.auto_hot_rows(n, k)
    assert remap.auto_hot_rows(1 << 26, 16) == 1 << 18


@pytest.mark.parametrize("n,min_ub,native", [(N, None, False),
                                             (N, 4096, False),
                                             (1 << 25, None, True)])
def test_split_prep_matches_jax(n, min_ub, native):
    """prep_batch with a remap: every array of the split batch equals the
    JAX package's, on the NumPy localizer and past 2^24 rows on the
    native one; its sorted slots too (the buckets' ids repeat across the
    split point, the lanes do not)."""
    h = H if n == N else 1 << 14
    _, lut = _lut(n, h, 2)
    b = _batch(7, B=512, n=n)
    runs = _native.RUNS["localize_native"]
    pb = prep_batch(b, n, min_ub=min_ub, remap=lut, hot_rows=h)
    ref = jprep_batch(_jbatch(b), n, min_ub=min_ub, remap=lut, hot_rows=h)
    if native and _native.available():
        assert _native.RUNS["localize_native"] == runs + 1
    for name in ("uids", "ucounts", "inv", "valid", "uids_hot",
                 "uids_cold"):
        got, want = getattr(pb, name), getattr(ref, name)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
    for with_slots in (False, True):
        ss = build_sorted_slots(pb.inv, pb.vals, with_slots=with_slots)
        js = jbuild_sorted_slots(ref.inv, ref.vals, ref.uids.shape[0],
                                 with_slots=with_slots)
        for name in ("x_sorted", "bidx", "inv_sorted", "slot_sorted"):
            got, want = getattr(ss, name), getattr(js, name)
            if want is None:
                assert got is None, name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def _stores(segsum, K=4, **kv):
    """The JAX and the port's split stores on one lut, from one canonical
    state."""
    bs, lut = _lut()
    kw = _kw(H, K, segsum=segsum, **kv)
    jcfg, cfg = JConfig.from_kwargs(kw), Config.from_kwargs(kw)
    jstore = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    jstore.set_remap(lut)
    store.set_remap(lut)
    s0 = _state(K)
    jst = jstore.place_state(jupd.FMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    return bs, lut, jstore, store, jst, st


def _jcanonical(jst, lut):
    return jcheckpoint._fetch_planar_host(jax.device_get(jst), lut)


@pytest.mark.parametrize("segsum,K,kv", [
    ("sorted", 4, {}), ("scatter", 4, {}), ("sorted", 0, {}),
    ("sorted", 4, {"w_updater": "adagrad", "V_updater": "sgd"}),
    ("scatter", 4, {"w_updater": "sgd", "tail_feature_filter": 2}),
])
def test_hotcold_store_matches_jax(segsum, K, kv):
    bs, lut, jstore, store, jst, st = _stores(segsum, K, **kv)
    assert isinstance(st, HotColdFMState) and st.hot_rows == H
    for b in bs[:3] + [_batch(11)]:
        jst, jm = jstore.train_step_prepped(
            jst, jprep_batch(_jbatch(b), N, remap=lut, hot_rows=H))
        st, m = store.train_step_prepped(
            st, prep_batch(b, N, remap=lut, hot_rows=H))
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
    got, ref = state_to_numpy(st, lut), _jcanonical(jst, lut)
    for name in LEAVES:
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **TOL)
    hb = _batch(99)
    _, jpy = jstore.eval_step_prepped(
        jst, jprep_batch(_jbatch(hb), N, remap=lut, hot_rows=H))
    _, py = store.eval_step_prepped(st, prep_batch(hb, N, remap=lut,
                                                   hot_rows=H))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), **PY_TOL)
    assert store.stats(st) == {
        k: float(v) for k, v in jax.device_get(jstore.stats(jst)).items()}


@pytest.mark.parametrize("segsum", ["sorted", "scatter"])
def test_split_trains_as_the_stacked_table(segsum):
    """The split is a layout: the port's split store and its stacked
    store train to the same canonical state from one state (the segment
    sums may split a key's run at other tile edges: rel 1e-5 / abs 1e-6)
    and score the same."""
    bs, lut, _, split, _, ss = _stores(segsum)
    cfg = Config.from_kwargs(_kw(0, segsum=segsum))
    stacked = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    st = stacked.place_state(state_from_numpy(_state()))
    for b in bs:
        st, ma = stacked.train_step_prepped(st, prep_batch(b, N))
        ss, mb = split.train_step_prepped(
            ss, prep_batch(b, N, remap=lut, hot_rows=H))
        assert float(ma.logloss_sum) == pytest.approx(
            float(mb.logloss_sum), rel=1e-6)
    a, c = state_to_numpy(st), state_to_numpy(ss, lut)
    for name in LEAVES:
        np.testing.assert_allclose(c[name], a[name], err_msg=name, **TOL)
    hb = _batch(99)
    _, p1 = stacked.eval_step_prepped(st, prep_batch(hb, N))
    _, p2 = split.eval_step_prepped(ss, prep_batch(hb, N, remap=lut,
                                                   hot_rows=H))
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), **PY_TOL)


def test_split_step_is_the_stacked_step_bit_for_bit():
    """One step of the split and the stacked store from one canonical
    state, the split fed the stacked step's per-key sums mapped to its
    lanes: the same pulled rows and updated state, bit for bit."""
    from test_torch_cuda import split_step_bits

    bs, lut, _, split, _, _ = _stores("sorted")
    cfg = Config.from_kwargs(_kw(0, segsum="sorted"))
    stacked = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    for b in bs:
        split_step_bits(stacked, split, lut, state_from_numpy(_state()), b)


def test_split_checkpoints_are_canonical_in_both_packages(tmp_path):
    """A split state saves canonical rows (without its lut it refuses);
    the JAX package reads the file into its split store under another
    lut and scores as the port does; JAX's split save loads into the
    port's; the carry functions round-trip through (lut, hot_rows)."""
    bs, lut, jstore, store, jst, st = _stores("sorted")
    for b in bs[:2]:
        st, _ = store.train_step_prepped(st, prep_batch(b, N, remap=lut,
                                                        hot_rows=H))
    with pytest.raises(ValueError, match="remap lut"):
        checkpoint.save(str(tmp_path / "x"), st)
    path = str(tmp_path / "port")
    checkpoint.save(path, st, {"epoch": 1}, remap_lut=lut)
    host, meta = jcheckpoint.load(path)
    canon = state_to_numpy(st, lut)
    for name in LEAVES:
        np.testing.assert_array_equal(np.asarray(getattr(host, name)),
                                      canon[name], err_msg=name)
    # a new run builds another lut: JAX's split store under it
    lut2 = remap.build_remap(remap.count_sample(
        iter([_batch(7), _batch(8)]), N, 2), H)
    jstore.set_remap(lut2)
    jst2, _ = jcheckpoint.load_for_store(path, jstore)
    hb = _batch(99)
    _, jpy = jstore.eval_step_prepped(
        jst2, jprep_batch(_jbatch(hb), N, remap=lut2, hot_rows=H))
    _, py = store.eval_step_prepped(st, prep_batch(hb, N, remap=lut,
                                                   hot_rows=H))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), **PY_TOL)
    # JAX's save of its split state loads into the port's, under lut2
    jpath = str(tmp_path / "jax")
    jcheckpoint.save(jpath, jst2, {"epoch": 1}, remap_lut=lut2)
    store.set_remap(lut2)
    st2, _ = checkpoint.load_for_store(jpath, store)
    for name, v in state_to_numpy(st2, lut2).items():
        np.testing.assert_array_equal(v, canon[name], err_msg=name)
    carried = state_from_numpy(canon, remap=(lut2, H))
    assert torch.equal(carried.hot, st2.hot)
    assert torch.equal(carried.cold, st2.cold)


def test_hot_rows_guards():
    """What the JAX store refuses, the port refuses with its messages;
    the config checks of the JAX package."""
    def store(kw):
        cfg = Config.from_kwargs(kw)
        return LocalStore(FMUpdater(cfg.model), cfg, device="cpu")

    for kernel in ("pairs", "pallas"):
        with pytest.raises(ValueError, match="kernel=xla"):
            store(_kw(H) + [("kernel", kernel)])
    with pytest.raises(ValueError, match="layout=stacked"):
        store(_kw(H) + [("layout", "packed")])
    with pytest.raises(ValueError, match="out of range"):
        store(_kw(N))
    with pytest.raises(ValueError, match="host_localize=1"):
        Config.from_kwargs(_kw(H) + [("host_localize", "0")])
    with pytest.raises(ValueError, match="SGD/LocalStore"):
        Config.from_kwargs(_kw(H) + [("learner", "bcd")])
    s = store(_kw(H))
    assert s.hot_rows == H and s.kernel == "xla" and s.layout == "stacked"
    with pytest.raises(ValueError, match="set_remap"):
        s.place_state(state_from_numpy(_state()))
    state = s.init_state(0)
    assert isinstance(state, HotColdFMState)
    assert state.hot.shape == (12, H) and state.cold.shape == (12, N - H)
    with pytest.raises(ValueError, match="unsplit"):
        s.train_step_prepped(state, prep_batch(_batch(0), N))
    b = _batch(0)
    with pytest.raises(ValueError, match="host-prepped"):
        s.train_step(state, b.ids, b.vals, b.labels, b.mask)
    with pytest.raises(ValueError, match="without hot_rows"):
        store(_kw(0)).set_remap(np.arange(N, dtype=np.int32))
    assert store(_kw(-1)).hot_rows == remap.auto_hot_rows(N, 4)


def test_hotcold_count_step_counts_each_id_once():
    """The count pass on a split state takes remapped ids, each into its
    own table: the counts of a NumPy bincount. The JAX store's matches
    them but for a reference quirk (ROADMAP D): its cold scatter of a hot
    id, ``id - H < 0``, wraps to the cold table's last H rows instead of
    dropping, so those rows gain the hot ids' counts."""
    bs, lut, jstore, store, jst, st = _stores("sorted")
    extra = np.zeros(N, np.float32)
    for b in bs:
        ids = remap.apply_remap(b.ids, lut)
        jst = jstore.count_step(jst, ids)
        st = store.count_step(st, ids)
        extra += np.bincount(ids[ids >= 0], minlength=N)
    want = _state()["cnt"] + extra[lut]  # canonical row h is lut[h]
    np.testing.assert_array_equal(state_to_numpy(st, lut)["cnt"], want)
    got_j = _jcanonical(jst, lut)["cnt"][np.argsort(lut)]  # remapped rows
    wrapped = np.arange(N - H, N)  # remapped rows: cold row id - H + (N - H)
    keep = np.ones(N, bool)
    keep[wrapped] = False
    np.testing.assert_array_equal(got_j[keep], want[np.argsort(lut)][keep])
    np.testing.assert_array_equal(got_j[wrapped],
                                  want[np.argsort(lut)][wrapped]
                                  + extra[:H])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hot")
    write_libsvm(make_ctr_data(4000, num_fields=8, vocab_per_field=200,
                               seed=1), str(d / "tr.svm"))
    write_libsvm(make_ctr_data(1000, num_fields=8, vocab_per_field=200,
                               seed=2), str(d / "va.svm"))
    return d


def _recipe(d, *extra):
    return [("data_in", str(d / "tr.svm")), ("data_val", str(d / "va.svm")),
            ("batch_size", "512"), ("num_bits", "13"),
            ("max_nnz_per_row", "8"), ("V_dim", "2"), ("kernel", "xla"),
            ("store", "local"), ("max_num_epochs", "2"), ("lr_eta", "0.1"),
            ("l1", "0.1"), ("V_lr_eta", "0.05"), ("report_interval", "0"),
            ("segsum", "scatter"), *extra]


def test_hotcold_learner_matches_jax(data, tmp_path):
    """``hot_rows=-1``: both learners build the same remap from the same
    count sample, before any state; from one start checkpoint they train
    within logloss rel 1e-5 and AUC abs 1e-5; the port's canonical save
    resumes in the JAX learner under a remap of its own, and predicts
    the same through ``task=predict`` in either package."""
    from difacto_tpu_torch import cli

    rng = np.random.default_rng(3)
    n = 1 << 13
    s0 = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s0["V"] = rng.uniform(-0.01, 0.01, (2, n)).astype(np.float32)
    s0["nV"] = np.zeros((2, n), np.float32)
    start, model = str(tmp_path / "start"), str(tmp_path / "model")
    jcheckpoint.save(start, jupd.FMState(**s0), {"epoch": 0})
    kw = _recipe(data, ("hot_rows", "-1"), ("hot_count_batches", "4"),
                 ("model_in", start))
    jl = JSGDLearner(JConfig.from_kwargs(kw))
    learner = SGDLearner(Config.from_kwargs(kw + [("model_out", model)]),
                         device="cpu")
    np.testing.assert_array_equal(learner.store.hot_lut, jl.store.hot_lut)
    assert isinstance(learner.state, HotColdFMState)
    jva, va = jl.run(), learner.run()
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.57
    # predict on the port's canonical checkpoint, both packages
    out = str(tmp_path / "pred.txt")
    args = [f"{k}={v}" for k, v in _recipe(data, ("hot_rows", "-1"),
                                           ("hot_count_batches", "2"))]
    assert cli.main(args + [f"data_in={data / 'va.svm'}", "task=predict",
                            f"model_in={model}", f"pred_out={out}"],
                    device="cpu") == 0
    jcfg = JConfig.from_kwargs(_recipe(data, ("model_in", model),
                                       ("hot_rows", "-1"),
                                       ("hot_count_batches", "2")))
    jpy, _ = JSGDLearner(jcfg).predict(str(data / "va.svm"))
    np.testing.assert_allclose(np.loadtxt(out), jpy, rtol=2e-5, atol=1e-5)
