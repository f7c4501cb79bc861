"""The compact batch cache (``cache_compact``) of the port against its full
form and against the JAX package.

A compact batch keeps only the sort permutation (``slot_sorted``); the
store derives x_sorted, bidx and inv_sorted from the batch's own ``vals``
and ``inv`` each step (learners/step.py::derive_sorted_slots). The derived
stream must be the host-built full form element for element, pads
included, so every LocalStore sorted path trains to the same bits in
either form. Against the JAX package: the same permutation, the split
store within its own compact test's tolerances (tests/test_hotcold.py),
and the learner within the learner tests' (logloss rel 1e-5, AUC abs
1e-5). The sharded store follows JAX's full form and refuses a compact
batch.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.batch_iter import Batch as JBatch
from difacto_tpu.data.prep import build_sorted_slots as jbuild_sorted_slots
from difacto_tpu.data.prep import \
    build_sorted_slots_sharded as jbuild_sorted_slots_sharded
from difacto_tpu.data.prep import prep_batch as jprep_batch
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters import updater as jupd
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data import remap
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import (SortedSlots, build_sorted_slots,
                                         prep_batch, prep_batch_sharded)
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.learners.step import derive_sorted_slots
from difacto_tpu_torch.parallel.store import LocalStore, ShardedStore
from difacto_tpu_torch.updaters.updater import FMUpdater
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy
from difacto_tpu_torch.utils.place import place_batch

torch.set_num_threads(2)

NB, H = 12, 512
N = 1 << NB
LEAVES = ("w", "z", "n", "V", "nV", "cnt")


def _batch(seed, B=256, L=10, F=0):
    """Zipf ids with a tenth of the slots padding; ``F`` > 0 adds
    explicit libffm fields in [0, F)."""
    r = np.random.default_rng(seed)
    ids = (r.zipf(1.3, (B, L)) % N).astype(np.int32)
    ids[r.random(ids.shape) < 0.1] = -1
    vals = np.where(ids >= 0, r.normal(size=ids.shape), 0.0).astype(
        np.float32)
    fields = (np.where(ids >= 0, r.integers(0, F, ids.shape), 0).astype(
        np.int32) if F else None)
    return Batch(ids, vals, (r.random(B) > 0.5).astype(np.float32),
                 np.ones(B, np.float32), fields)


def _jbatch(b):
    return JBatch(b.ids, b.vals, b.labels, b.mask, b.fields)


def _lut(batches=4):
    bs = [_batch(i) for i in range(batches)]
    return remap.build_remap(remap.count_sample(iter(bs), N, batches), H)


def _state(K, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=N).astype(np.float32) * 0.1,
            "z": rng.normal(size=N).astype(np.float32),
            "n": np.abs(rng.normal(size=N)).astype(np.float32),
            "V": rng.normal(size=(K, N)).astype(np.float32) * 0.1,
            "nV": np.abs(rng.normal(size=(K, N))).astype(np.float32),
            "cnt": rng.integers(0, 5, N).astype(np.float32)}


# (B, L): a stream with 512 pad slots, one with none (B*L a multiple of
# the 1024-slot tile), and one with a single real slot past a tile
SHAPES = [(256, 10), (512, 2), (1025, 1)]


@pytest.mark.parametrize("B,L", SHAPES)
@pytest.mark.parametrize("split", [False, True])
def test_compact_host_arrays_match_jax(B, L, split):
    """build_sorted_slots(compact=True): the JAX package's permutation,
    pads 0, and none of the derived arrays, on a plain and a split
    batch."""
    lut = _lut() if split else None
    b = _batch(5, B, L)
    pb = prep_batch(b, N, remap=lut, hot_rows=H if split else 0)
    jpb = jprep_batch(_jbatch(b), N, remap=lut, hot_rows=H if split else 0)
    np.testing.assert_array_equal(pb.inv, jpb.inv)
    ss = build_sorted_slots(pb.inv, pb.vals, compact=True)
    js = jbuild_sorted_slots(jpb.inv, jpb.vals, jpb.uids.shape[0],
                             compact=True)
    assert ss.compact
    for name in ("x_sorted", "bidx", "inv_sorted"):
        assert getattr(ss, name) is None and getattr(js, name) is None, name
    np.testing.assert_array_equal(ss.slot_sorted, js.slot_sorted)
    assert ss.slot_sorted.dtype == js.slot_sorted.dtype == np.int32
    full = build_sorted_slots(pb.inv, pb.vals, with_slots=True)
    np.testing.assert_array_equal(ss.slot_sorted, full.slot_sorted)
    assert not full.compact
    assert not ss.slot_sorted[B * L:].any()


@pytest.mark.parametrize("B,L", SHAPES)
def test_derived_stream_is_the_host_full_form(B, L):
    """derive_sorted_slots gives the host's full form exactly (x bit for
    bit, bidx and inv_sorted as int32), and inv_sorted is non-decreasing
    with every pad slot on the last real lane.

    The JAX derivation gives the pads lane ``inv[slot_sorted[pad]] =
    inv[0]``, checked below to break monotonicity wherever there are
    pads. The TPU kernel reads a host-built schedule, so it does not
    care. The port's B3 on the card finds segments by comparing adjacent
    lanes, so a pad run of lane inv[0] after larger lanes would be a
    second segment of that lane, and its zero sum could overwrite the
    lane's real one. On the CPU B3's plain version is ``index_add_``,
    which ignores order, so only this check (and the card) sees it."""
    b = _batch(6, B, L)
    pb = prep_batch(b, N)
    full = build_sorted_slots(pb.inv, pb.vals)
    ss = build_sorted_slots(pb.inv, pb.vals, compact=True)
    x, bidx, inv_s = derive_sorted_slots(torch.from_numpy(pb.vals),
                                         torch.from_numpy(pb.inv),
                                         torch.from_numpy(ss.slot_sorted))
    assert x.dtype == torch.float32
    assert bidx.dtype == inv_s.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy().view(np.int32),
                                  full.x_sorted.view(np.int32))
    np.testing.assert_array_equal(bidx.numpy(), full.bidx)
    np.testing.assert_array_equal(inv_s.numpy(), full.inv_sorted)
    lanes = inv_s.numpy()
    assert (np.diff(lanes) >= 0).all()
    bl = B * L
    assert (lanes[bl:] == lanes[bl - 1]).all()
    # the JAX package's pad rule, for contrast
    jlanes = np.asarray(jnp.asarray(pb.inv)[jnp.asarray(ss.slot_sorted)])
    np.testing.assert_array_equal(jlanes[:bl], lanes[:bl])
    if bl < lanes.shape[0]:
        assert (jlanes[bl:] == pb.inv[0]).all()
        # monotone only where slot 0 holds the last lane (a padding slot's)
        assert (np.diff(jlanes) >= 0).all() == (pb.inv[0] == lanes[bl - 1])


# every LocalStore sorted path: (config on top of _kw's, V_dim, libffm
# fields F, hot/cold split)
PATHS = {
    "pairs-packed": ((("layout", "packed"),), 4, 0, False),
    "pairs-planar": ((("layout", "planar"),), 4, 0, False),
    "xla": ((("kernel", "xla"),), 4, 0, False),
    "split": ((("kernel", "xla"), ("hot_rows", str(H))), 4, 0, True),
    "pallas-planar": ((("kernel", "pallas"), ("segsum", "sorted"),
                       ("layout", "planar")), 4, 0, False),
    "pallas-packed": ((("kernel", "pallas"), ("segsum", "sorted"),
                       ("layout", "packed")), 4, 0, False),
    "ffm": ((("loss", "ffm"),), 2, 0, False),
    "ffm-xla": ((("loss", "ffm"), ("kernel", "xla")), 2, 0, False),
    "ffm-libffm": ((("loss", "ffm"), ("data_format", "libffm"),
                    ("num_fields", "4")), 2, 4, False),
    "logit": ((), 0, 0, False),
}


def _kw(extra, K, compact):
    return [("batch_size", "256"), ("num_bits", str(NB)),
            ("max_nnz_per_row", "10"), ("V_dim", str(K)), ("l1", "0.1"),
            ("lr_eta", "0.1"), ("V_lr_eta", "0.05"), ("V_threshold", "1"),
            ("cache_compact", str(int(compact))), *extra]


def _port_store(extra, K, compact, lut=None):
    cfg = Config.from_kwargs(_kw(extra, K, compact))
    store = LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu")
    if lut is not None:
        store.set_remap(lut)
    return store


@pytest.mark.parametrize("path", list(PATHS))
def test_compact_step_is_the_full_step_bit_for_bit(path):
    """Three train steps and an eval from one state, with the store
    building the sorted slots itself: the compact store's batches keep
    only the permutation, and its tables, metrics and margins hold the
    full store's bits on every LocalStore sorted path."""
    extra, K, F, split = PATHS[path]
    lut = _lut() if split else None
    runs = []
    for compact in (False, True):
        store = _port_store(extra, K, compact, lut)
        assert store.sorted_grads
        width = store.param.V_dim
        st = store.place_state(state_from_numpy(_state(width)))
        losses = []
        for s in range(3):
            pb = prep_batch(_batch(s, F=F), N, remap=lut,
                            hot_rows=store.hot_rows, num_fields=F)
            st, m = store.train_step_prepped(st, pb)
            assert pb.sorted_slots.compact == compact
            assert pb.sorted_slots.slot_sorted is not None or (
                not compact and store.loss != "ffm")
            losses.append(float(m.logloss_sum))
        _, py = store.eval_step_prepped(st, prep_batch(
            _batch(9, F=F), N, remap=lut, hot_rows=store.hot_rows,
            num_fields=F))
        runs.append((state_to_numpy(st, lut), losses, py))
    (a, la, pa), (c, lc, pc) = runs
    assert la == lc
    for name in LEAVES:
        np.testing.assert_array_equal(a[name].view(np.int32),
                                      c[name].view(np.int32), err_msg=name)
    assert torch.equal(pa.view(torch.int32), pc.view(torch.int32))


def test_compact_split_store_matches_jax():
    """The port's compact split store against JAX's compact split store
    from one canonical state, as tests/test_hotcold.py holds JAX's compact
    store to its full one: logloss sums at rtol 1e-6, eval margins at
    rtol 1e-4 / atol 1e-5."""
    lut = _lut()
    extra = (("kernel", "xla"), ("hot_rows", str(H)), ("segsum", "sorted"),
             ("store", "local"))
    jcfg = JConfig.from_kwargs(_kw(extra, 4, True))
    jstore = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg)
    store = _port_store(extra, 4, True, lut)
    jstore.set_remap(lut)
    s0 = _state(4)
    jst = jstore.place_state(jupd.FMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(3):
        b = _batch(s)
        jpb = jprep_batch(_jbatch(b), N, remap=lut, hot_rows=H)
        jpb.sorted_slots = jbuild_sorted_slots(jpb.inv, jpb.vals,
                                               jpb.uids.shape[0],
                                               compact=True)
        pb = prep_batch(b, N, remap=lut, hot_rows=H)
        pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals, compact=True)
        jst, jm = jstore.train_step_prepped(jst, jpb)
        st, m = store.train_step_prepped(st, pb)
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-6)
    hb = _batch(99)
    _, jpy = jstore.eval_step_prepped(
        jst, jprep_batch(_jbatch(hb), N, remap=lut, hot_rows=H))
    _, py = store.eval_step_prepped(st, prep_batch(hb, N, remap=lut,
                                                   hot_rows=H))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), rtol=1e-4,
                               atol=1e-5)


def test_place_batch_skips_the_absent_arrays():
    """A compact batch places its permutation and leaves the three
    derived arrays absent."""
    pb = prep_batch(_batch(1), N)
    pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals, compact=True)
    placed = place_batch(pb, torch.device("cpu"))
    ss = placed.sorted_slots
    assert ss.compact and isinstance(ss.slot_sorted, torch.Tensor)
    assert ss.x_sorted is None and ss.bidx is None and ss.inv_sorted is None
    np.testing.assert_array_equal(ss.slot_sorted.numpy(),
                                  pb.sorted_slots.slot_sorted)


def test_sorted_slots_refuse_a_partial_form():
    """All three derived arrays or none, and none needs the
    permutation."""
    a = np.zeros(1024, np.int32)
    with pytest.raises(ValueError, match="slot_sorted"):
        SortedSlots(None, None, None)
    with pytest.raises(ValueError, match="all of"):
        SortedSlots(a.astype(np.float32), None, a, slot_sorted=a)
    assert SortedSlots(None, None, None, slot_sorted=a).compact


# -- the learner ------------------------------------------------------------

BITS, K = 14, 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("compact")
    write_libsvm(make_ctr_data(4000, num_fields=10, vocab_per_field=300,
                               seed=1), str(d / "train.svm"))
    write_libsvm(make_ctr_data(1000, num_fields=10, vocab_per_field=300,
                               seed=2), str(d / "val.svm"))
    return d


def _recipe(d, *extra):
    return [
        ("data_in", str(d / "train.svm")), ("data_val", str(d / "val.svm")),
        ("batch_size", "500"), ("num_bits", str(BITS)),
        ("max_nnz_per_row", "12"), ("V_dim", str(K)), ("lr_eta", "0.1"),
        ("l1", "0.1"), ("V_lr_eta", "0.05"), ("max_num_epochs", "3"),
        ("cache_batches", "1"), ("cache_on_device", "1"),
        ("report_interval", "0"), ("store", "local"), *extra,
    ]


def _start(tmp_path):
    rng = np.random.default_rng(3)
    n = 1 << BITS
    s = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s["V"] = rng.uniform(-0.01, 0.01, (K, n)).astype(np.float32)
    s["nV"] = np.zeros((K, n), np.float32)
    start = str(tmp_path / "start")
    jcheckpoint.save(start, jupd.FMState(**s), {"epoch": 0})
    return start


def _train_items(learner, uri):
    return [pb for key, (_, items) in learner._batch_cache.items()
            if key.startswith(uri + "|") for pb in items]


@pytest.mark.parametrize("extra", [(), (("kernel", "xla"),),
                                   (("hot_rows", "-1"),)],
                         ids=["auto", "xla", "split"])
def test_compact_learner_matches_jax(data, tmp_path, extra):
    """Three epochs over a device cache with ``cache_compact=1``: the
    JAX learner's validation logloss within rel 1e-5 and AUC within abs
    1e-5 (from one start checkpoint), the port's full-form run's table
    bit for bit, and cached train batches that keep only the
    permutation (``kernel=auto`` is pairs in the port and compacts there
    too, where the JAX learner keeps the full form)."""
    kw = _recipe(data, ("model_in", _start(tmp_path)), *extra)
    jva = JSGDLearner(JConfig.from_kwargs(kw + [("cache_compact", "1")])).run()
    runs = []
    for compact in ("0", "1"):
        learner = SGDLearner(Config.from_kwargs(
            kw + [("cache_compact", compact)]), device="cpu")
        va = learner.run()
        items = _train_items(learner, str(data / "train.svm"))
        assert len(items) == 8
        for pb in items:
            ss = pb.sorted_slots
            assert ss.compact == (compact == "1")
            if ss.compact:
                assert isinstance(ss.slot_sorted, torch.Tensor)
        runs.append((va, state_to_numpy(learner.state,
                                        learner.store.hot_lut)))
    (vf, sf), (va, sc) = runs
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert (va.logloss, va.exact_auc) == (vf.logloss, vf.exact_auc)
    for name in LEAVES:
        np.testing.assert_array_equal(sc[name].view(np.int32),
                                      sf[name].view(np.int32), err_msg=name)


# -- the sharded store --------------------------------------------------------


def test_sharded_store_keeps_the_full_form_and_refuses_a_compact_batch():
    """The sharded store ignores the key, as the JAX package's sharded
    prep does (it takes no ``compact``): with ``cache_compact=1`` it
    builds the full form and trains to the bits of ``cache_compact=0``.
    Handed a compact batch, it raises a ValueError naming the key."""
    assert "compact" not in inspect.signature(
        jbuild_sorted_slots_sharded).parameters
    outs = []
    for compact in (False, True):
        cfg = Config.from_kwargs(_kw((("store", "sharded"),), 4, compact))
        store = ShardedStore(FMUpdater(cfg.model), cfg, device="cpu")
        st = store.place_state(state_from_numpy(_state(4)))
        for s in range(2):
            pb = prep_batch_sharded(_batch(s), N, 1)
            st, _ = store.train_step_prepped(st, pb)
            assert not pb.sorted_slots.compact
        outs.append(state_to_numpy(store.gather_state(st)))
    for name in LEAVES:
        np.testing.assert_array_equal(outs[0][name], outs[1][name],
                                      err_msg=name)
    pb = prep_batch_sharded(_batch(3), N, 1)
    perm = build_sorted_slots(pb.inv, pb.vals, compact=True).slot_sorted
    pb.sorted_slots = SortedSlots(None, None, None, slot_sorted=perm[None])
    with pytest.raises(ValueError, match="cache_compact"):
        store.train_step_prepped(st, pb)

