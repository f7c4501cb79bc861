"""The port's XLA table path (``kernel=xla``, ``layout=stacked``) against
the JAX package.

The same NumPy start state and batches go through the JAX LocalStore on
``kernel=xla`` (its segment sum in interpret mode for ``segsum=sorted``,
as tests/test_hotcold.py runs it) and the port's, on the stacked, planar
and row-major tables: five train steps, then an eval batch; leaves within
rel 1e-5 / abs 1e-6 of JAX's, the eval margins (sums over a row's
slots and factor pairs) within rel 1e-5 / abs 2e-5. The learner recipe trains on the path
within logloss rel 1e-5 and AUC abs 1e-5 of the JAX learner, whose
``kernel=auto`` is this path on the CPU. Also the stacked state's carry,
init and checkpoints, and how ``kernel`` and ``layout`` resolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fm_leaves

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.batch_iter import Batch as JBatch
from difacto_tpu.data.prep import prep_batch as jprep_batch
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.parallel.store import _kernel_kind as jkernel_kind
from difacto_tpu.updaters import updater as jupd
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import prep_batch
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import (FMState, FMUpdater,
                                                PackedFMState, StackedFMState,
                                                stack_state, unstack_state)
from difacto_tpu_torch.utils import checkpoint
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

NB = 12
N = 1 << NB
LEAVES = ("w", "z", "n", "V", "nV", "cnt")
TOL = dict(rtol=1e-5, atol=1e-6)    # leaves
PY_TOL = dict(rtol=1e-5, atol=2e-5)  # margins


def _kw(K, extra=()):
    return [("batch_size", "256"), ("num_bits", str(NB)),
            ("max_nnz_per_row", "12"), ("V_dim", str(K)), ("l1", "0.1"),
            ("lr_eta", "0.1"), ("V_lr_eta", "0.05"), *extra]


def _start_state(K, seed=7, n=N):
    """A trained-looking NumPy start state both stores are given (torch
    cannot draw jax.random's bits)."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=n) * 0.1).astype(np.float32),
            "z": rng.normal(size=n).astype(np.float32),
            "n": rng.random(n).astype(np.float32),
            "cnt": rng.integers(0, 4, n).astype(np.float32),
            "V": rng.uniform(-0.1, 0.1, (K, n)).astype(np.float32),
            "nV": rng.random((K, n)).astype(np.float32)}


def _batch(seed, B=256, L=12, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, (B, L)) % N).astype(np.int32)
    ids[rng.random((B, L)) < pad_frac] = -1
    vals = np.where(ids < 0, 0.0, rng.normal(size=(B, L))).astype(np.float32)
    return Batch(ids, vals, (rng.random(B) > 0.5).astype(np.float32),
                 np.ones(B, np.float32))


def _jprep(b, n=N, **kw):
    return jprep_batch(JBatch(b.ids, b.vals, b.labels, b.mask), n, **kw)


def _assert_leaves(got: dict, ref, what=""):
    for name in LEAVES:
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   err_msg=f"{what} {name}", **TOL)


def _steps_and_eval(jstore, store, s0, steps=5):
    """Train steps of both stores from one NumPy state, then an eval
    batch; returns the port's state."""
    jst = jstore.place_state(jupd.FMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(steps):
        b = _batch(s)
        jst, jm = jstore.train_step_prepped(jst, _jprep(b))
        st, m = store.train_step_prepped(st, prep_batch(b, N))
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
    _assert_leaves(state_to_numpy(st), fm_leaves(jst))
    b = _batch(99)
    jm, jpy = jstore.eval_step_prepped(jst, _jprep(b))
    m, py = store.eval_step_prepped(st, prep_batch(b, N))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), **PY_TOL)
    np.testing.assert_allclose(m.auc_hist.numpy(), np.asarray(jm.auc_hist))
    return st


_STATES = {"stacked": StackedFMState, "planar": FMState,
           "packed": PackedFMState}


@pytest.mark.parametrize("layout", ["stacked", "planar", "packed"])
@pytest.mark.parametrize("segsum", ["sorted", "scatter"])
@pytest.mark.parametrize("K,extra", [(4, ()), (0, ())],
                         ids=["K4", "K0"])
def test_xla_store_matches_jax(layout, segsum, K, extra):
    """Each XLA layout with either backward against the JAX store on the
    same layout and backward."""
    kw = _kw(K, extra) + [("kernel", "xla"), ("layout", layout),
                          ("segsum", segsum)]
    jcfg, cfg = JConfig.from_kwargs(kw), Config.from_kwargs(kw)
    jstore = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.xla and store.layout == jstore.layout == layout
    assert store.sorted_grads == jstore.sorted_grads == (segsum == "sorted")
    st = _steps_and_eval(jstore, store, _start_state(K))
    assert isinstance(st, _STATES[layout])


@pytest.mark.parametrize("extra", [
    (("w_updater", "adagrad"), ("V_updater", "sgd")),
    (("w_updater", "sgd"), ("tail_feature_filter", "2")),
    (("V_threshold", "0"), ("segsum", "scatter")),
])
def test_stacked_updaters_match_jax(extra):
    """The stacked delta's other updaters, the tail filter and an ungated
    V (``kernel=xla`` with ``segsum=auto``: sorted, as on the JAX
    package's accelerator)."""
    kw = _kw(4, extra) + [("kernel", "xla")]
    cfg = Config.from_kwargs(kw)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.layout == "stacked"
    jcfg = JConfig.from_kwargs(kw)
    jcfg.shard.segsum = "sorted" if store.sorted_grads else "scatter"
    _steps_and_eval(JLocalStore(jupd.FMUpdater(jcfg.model), jcfg), store,
                    _start_state(4))


@pytest.mark.parametrize("segsum", ["sorted", "scatter"])
def test_stacked_ffm_matches_jax(segsum):
    """loss=ffm (slot position as field, L = 6, k = 2: K = 12) on the
    stacked table."""
    L = 6
    kw = [("batch_size", "128"), ("num_bits", str(NB)),
          ("max_nnz_per_row", str(L)), ("V_dim", "2"), ("loss", "ffm"),
          ("l1", "0.1"), ("lr_eta", "0.1"), ("V_lr_eta", "0.05"),
          ("V_threshold", "1"), ("kernel", "xla"), ("segsum", segsum)]
    jcfg, cfg = JConfig.from_kwargs(kw), Config.from_kwargs(kw)
    jstore = JLocalStore(jupd.FMUpdater(jcfg.effective_model_param()), jcfg)
    store = LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu")
    s0 = _start_state(12)
    jst = jstore.place_state(jupd.FMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(3):
        b = _batch(s, B=128, L=L)
        jst, jm = jstore.train_step_prepped(jst, _jprep(b))
        st, m = store.train_step_prepped(st, prep_batch(b, N))
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
    assert isinstance(st, StackedFMState)
    _assert_leaves(state_to_numpy(st), fm_leaves(jst))


def test_stacked_state_init_carry_and_views():
    """init_state_stacked draws init_state's values into one table; the
    stacked table carries across the packages both ways; its leaves are
    views of its rows; place_state builds the same table as JAX's."""
    cfg = Config.from_kwargs(_kw(4) + [("kernel", "xla")])
    upd = FMUpdater(cfg.model)
    a = stack_state(upd.init_state(N, 3, "cpu"))
    b = upd.init_state_stacked(N, 3, "cpu")
    assert torch.equal(a.tbl, b.tbl)
    s0 = _start_state(4)
    jcfg = JConfig.from_kwargs(_kw(4) + [("kernel", "xla")])
    jst = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg).place_state(
        jupd.FMState(**s0))
    assert isinstance(jst, jupd.StackedFMState)
    st = LocalStore(upd, cfg, device="cpu").place_state(state_from_numpy(s0))
    np.testing.assert_array_equal(st.tbl.numpy(), np.asarray(jst.tbl))
    back = state_from_numpy(jax.device_get(jst), layout="stacked")
    assert torch.equal(back.tbl, st.tbl)
    for name, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, s0[name], err_msg=name)
    st.V[1, 5] = 2.5  # a view: the write lands in the table
    assert float(st.tbl[5, 5]) == 2.5
    assert torch.equal(unstack_state(st).V, st.tbl[4:8])


@pytest.mark.parametrize("kw,kernel,layout", [
    ((), "pairs", "packed"),
    ((("V_dim", "0"),), "pairs", "planar"),
    ((("kernel", "xla"),), "xla", "stacked"),
    ((("hot_rows", "512"),), "xla", "stacked"),
    ((("host_localize", "0"),), "xla", "stacked"),
    ((("layout", "stacked"),), "xla", "stacked"),
    ((("host_localize", "0"), ("kernel", "pallas")), "pallas", "packed"),
    ((("kernel", "xla"), ("layout", "packed")), "xla", "packed"),
])
def test_kernel_auto_resolution(kw, kernel, layout):
    """``kernel=auto`` is ``xla`` with ``hot_rows`` or
    ``host_localize=0``, as the JAX store resolves it on any backend, and
    with ``layout=stacked`` (the one path that takes it), and the port's
    measured ``pairs`` otherwise; ``layout=auto`` is ``stacked`` on
    ``xla``, as in the JAX store."""
    kv = [("num_bits", str(NB)), ("V_dim", "4"), *kw]
    cfg = Config.from_kwargs(kv)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert (store.kernel, store.layout) == (kernel, layout)
    assert store.sorted_grads == (kernel != "pallas")
    if dict(kw).get("hot_rows") or dict(kw).get("host_localize") == "0":
        assert jkernel_kind(JConfig.from_kwargs(kv)) == kernel


@pytest.mark.parametrize("kernel", ["pallas", "pairs"])
def test_stacked_needs_the_xla_path(kernel):
    """``layout=stacked`` with the table kernels raises the JAX store's
    ValueError in both packages."""
    kw = [("num_bits", str(NB)), ("kernel", kernel), ("layout", "stacked")]
    with pytest.raises(ValueError, match="incompatible with kernel="):
        LocalStore(FMUpdater(Config.from_kwargs(kw).model),
                   Config.from_kwargs(kw), device="cpu")
    jcfg = JConfig.from_kwargs(kw)
    with pytest.raises(ValueError, match="incompatible with kernel="):
        JLocalStore(jupd.FMUpdater(jcfg.model), jcfg, interpret=True)


def test_pairs_with_device_localize_is_refused():
    """``kernel=pairs host_localize=0``: the JAX store builds a pairs
    store whose raw-batch step trains on its XLA ops, not on the pair
    kernels (ROADMAP D); the port refuses the config, and the raw step of
    a pairs store."""
    kw = [("num_bits", str(NB)), ("kernel", "pairs"), ("host_localize", "0")]
    with pytest.raises(ValueError, match="kernel=pairs needs host_localize=1"):
        Config.from_kwargs(kw)
    jcfg = JConfig.from_kwargs(kw)
    jstore = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg, interpret=True)
    assert jstore.pairs and not jstore.pallas  # trains on XLA ops
    cfg = Config.from_kwargs(kw[:2])
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    b = _batch(0)
    with pytest.raises(ValueError, match="host-prepped"):
        store.train_step(store.init_state(0), b.ids, b.vals, b.labels,
                         b.mask)


def test_stacked_count_step_and_stats_match_jax():
    kw = _kw(4) + [("kernel", "xla")]
    jcfg, cfg = JConfig.from_kwargs(kw), Config.from_kwargs(kw)
    jstore = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    s0 = _start_state(4)
    jst = jstore.place_state(jupd.FMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(3):
        ids = _batch(s).ids
        jst = jstore.count_step(jst, jnp.asarray(ids))
        st = store.count_step(st, ids)
    np.testing.assert_array_equal(state_to_numpy(st)["cnt"],
                                  np.asarray(fm_leaves(jst).cnt))
    jstats = jax.device_get(jstore.stats(jst))
    assert store.stats(st) == {k: float(v) for k, v in jstats.items()}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("xla")
    write_libsvm(make_ctr_data(4000, num_fields=8, vocab_per_field=200,
                               seed=1), str(d / "tr.svm"))
    write_libsvm(make_ctr_data(1000, num_fields=8, vocab_per_field=200,
                               seed=2), str(d / "va.svm"))
    return d


def _recipe(d, *extra):
    return [("data_in", str(d / "tr.svm")), ("data_val", str(d / "va.svm")),
            ("batch_size", "512"), ("num_bits", "13"),
            ("max_nnz_per_row", "8"), ("V_dim", "4"), ("lr_eta", "0.1"),
            ("l1", "0.1"), ("V_lr_eta", "0.05"), ("max_num_epochs", "2"),
            ("store", "local"), ("report_interval", "0"), *extra]


@pytest.mark.parametrize("layout,segsum", [("stacked", "scatter"),
                                           ("planar", "sorted")])
def test_xla_recipe_matches_jax(data, tmp_path, layout, segsum):
    """The learner on ``kernel=xla`` against the JAX learner on its
    ``kernel=xla`` (scatter backward) from one start state: logloss rel
    1e-5, AUC abs 1e-5. The port's checkpoint is the planar interchange
    format, which the JAX package loads into its stacked store."""
    start, model = str(tmp_path / "start"), str(tmp_path / "model")
    jcheckpoint.save(start, jupd.FMState(**_start_state(4, n=1 << 13)),
                     {"epoch": 0})
    kw = _recipe(data, ("model_in", start), ("kernel", "xla"))
    jva = JSGDLearner(JConfig.from_kwargs(kw + [("segsum", "scatter")])).run()
    learner = SGDLearner(Config.from_kwargs(
        kw + [("layout", layout), ("segsum", segsum),
              ("model_out", model)]), device="cpu")
    assert isinstance(learner.state, _STATES[layout])
    va = learner.run()
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    jl = JSGDLearner(JConfig.from_kwargs(_recipe(
        data, ("model_in", model), ("kernel", "xla"))))
    assert isinstance(jl.state, jupd.StackedFMState)
    ref = jax.device_get(jupd.unstack_state(jl.state))
    for name, v in state_to_numpy(learner.state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, name)),
                                      err_msg=name)
    host, meta = checkpoint.load(model)
    assert meta["epoch"] == 2 and host.V.shape == (4, 1 << 13)


@pytest.mark.parametrize("layout", ["stacked", "planar", "packed"])
def test_pad_lanes_leave_the_table_bit_for_bit(layout):
    """The lanes no id fills reach the update with per-key sums poisoned
    to Inf (the undefined sums the JAX store zeroes before its update):
    no NaN is committed, and every row the batch does not hold keeps its
    bits, a ``-0.0`` included, in the rows the pad lanes clamp to (0 on
    the planar and row-major tables, N-1 on the stacked one)."""
    from difacto_tpu_torch.learners.step import worker_grads_sorted
    from difacto_tpu_torch.ops.localize import Localized

    cfg = Config.from_kwargs(_kw(4) + [("kernel", "xla"),
                                       ("layout", layout)])
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    s0 = _start_state(4)
    for name in ("w", "z", "V", "nV"):
        s0[name][..., [0, N - 1]] = -0.0
    st = store.place_state(state_from_numpy(s0))
    b = _batch(3)
    b.ids[(b.ids == 0) | (b.ids == N - 1)] = 5
    pb = store._placed(prep_batch(b, N), need_slots=True)
    assert not bool(pb.valid.all())
    loc = Localized(pb.uids, pb.inv, pb.ucounts, pb.valid)
    rows_u, raw = store._pull(st, loc)
    ss = pb.sorted_slots
    grads, _, _ = worker_grads_sorted(rows_u, loc, pb.vals, pb.labels,
                                      pb.mask, (ss.x_sorted, ss.bidx,
                                                ss.inv_sorted))
    grads = torch.where(pb.valid[None, :], grads, float("inf"))
    st = store._apply(st, loc, grads, raw)
    got = state_to_numpy(st)
    held = np.zeros(N, bool)
    held[pb.uids[pb.valid].numpy()] = True
    for name in LEAVES:
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_array_equal(
            got[name][..., ~held].view(np.int32),
            s0[name][..., ~held].view(np.int32), err_msg=name)
