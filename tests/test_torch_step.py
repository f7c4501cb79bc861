"""The port's losses, worker step and LocalStore against the JAX package.

Same NumPy inputs through both packages on the CPU: the loss math, the
histogram AUC, the per-key gradients (the port's sorted segment-sum path
and its scatter baseline against JAX's scatter path), and the slice as a
whole — five prepped train steps of the port's LocalStore against the JAX
LocalStore on its XLA path (kernel=xla, segsum=scatter) and on each
kernel path the port takes (Pallas in interpret mode), from one state
carried across by ``state_from_numpy``, then the eval scores.
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
from difacto_tpu.learners import step as jstep
from difacto_tpu.models import losses as jlosses
from difacto_tpu.ops import metrics as jmetrics
from difacto_tpu.ops.localize import Localized as JLocalized
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
from difacto_tpu_torch.learners import step
from difacto_tpu_torch.models import losses
from difacto_tpu_torch.ops import metrics
from difacto_tpu_torch.ops.localize import Localized
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import FMUpdater, PackedFMState
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

T = torch.from_numpy


def _dense(seed, B=64, L=10, K=4, pad_frac=0.2):
    """A [B, L] batch with padding slots (vals == 0) and rows W, V."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(B, L)).astype(np.float32)
    vals[rng.random((B, L)) < pad_frac] = 0.0
    W = rng.normal(size=(B, L)).astype(np.float32) * 0.3
    V = rng.normal(size=(B, L, K)).astype(np.float32) * 0.3
    labels = (rng.random(B) > 0.5).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    return vals, W, V, labels, mask


@pytest.mark.parametrize("K", [0, 4])
def test_fm_predict_and_loss_grad_match_jax(K):
    vals, W, V, labels, mask = _dense(K, K=K)
    jf = jlosses.fm_predict(vals, W, V)
    tf = losses.fm_predict(T(vals), T(W), T(V))
    np.testing.assert_allclose(tf.py.numpy(), np.asarray(jf.py), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tf.S.numpy(), np.asarray(jf.S), rtol=1e-5,
                               atol=1e-6)
    jfwd, jg = jlosses.fm_loss_grad(vals, W, V, labels, mask)
    tfwd, tg = losses.fm_loss_grad(T(vals), T(W), T(V), T(labels), T(mask))
    for name in ("dW", "dV", "loss", "correct"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_logit_grad_coeff_and_auc_hist_match_jax():
    rng = np.random.default_rng(3)
    py = (rng.normal(size=500) * 4).astype(np.float32)
    py[:3] = [80.0, -80.0, 0.0]  # saturating margins
    labels = (rng.random(500) > 0.4).astype(np.float32)
    mask = (rng.random(500) > 0.1).astype(np.float32)
    for a, b in zip(jlosses.logit_grad_coeff(py, labels, mask),
                    losses.logit_grad_coeff(T(py), T(labels), T(mask))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    h0 = rng.random((2, metrics.NUM_AUC_BINS)).astype(np.float32)
    ref = jmetrics.auc_hist_update(jnp.asarray(h0), py, labels, mask)
    got = metrics.auc_hist_update(T(h0), T(py), T(labels), T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    hist = np.asarray(ref, np.float64)
    assert metrics.auc_from_hist(hist) == pytest.approx(
        jmetrics.auc_from_hist(hist), rel=1e-12)
    assert metrics.auc_hist_error_bound(hist) == pytest.approx(
        jmetrics.auc_hist_error_bound(hist), rel=1e-12)
    assert metrics.exact_auc(labels, py) == jmetrics.exact_auc(labels, py)


def _batch(seed, B=256, L=12, N=4096, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < pad_frac] = -1
    vals = np.where(ids < 0, 0.0, rng.normal(size=(B, L))).astype(np.float32)
    return Batch(ids, vals, (rng.random(B) > 0.5).astype(np.float32),
                 np.ones(B, np.float32))


@pytest.mark.parametrize("K", [0, 4])
def test_worker_grads_match_jax(K):
    """The port's sorted path (segment sums + gV factoring) and its
    scatter baseline against JAX's scatter ``worker_grads``."""
    N = 4096
    pb = prep_batch(_batch(5), N)
    ss = build_sorted_slots(pb.inv, pb.vals)
    U = pb.uids.shape[0]
    rows_u = (np.random.default_rng(0).normal(size=(U, 1 + K)) * 0.1
              ).astype(np.float32)
    jloc = JLocalized(uids=jnp.asarray(pb.uids), inv=jnp.asarray(pb.inv),
                      counts=jnp.asarray(pb.ucounts),
                      valid=jnp.asarray(pb.valid))
    g_ref, py_ref, m_ref = jstep.worker_grads(
        jnp.asarray(rows_u), jloc, jnp.asarray(pb.vals),
        jnp.asarray(pb.labels), jnp.asarray(pb.mask))
    g_ref = np.asarray(g_ref)
    loc = Localized(uids=T(pb.uids), inv=T(pb.inv), counts=T(pb.ucounts),
                    valid=T(pb.valid))
    args = (T(rows_u), loc, T(pb.vals), T(pb.labels), T(pb.mask))
    g_s, py_s, m_s = step.worker_grads_sorted(
        *args, (T(ss.x_sorted), T(ss.bidx), T(ss.inv_sorted)))
    g_x, py_x, m_x = step.worker_grads(*args)
    # the junk lane (ub-1) collects the padding slots (x == 0); both
    # packages mask it with `valid` downstream
    v = pb.valid
    np.testing.assert_allclose(g_s.numpy().T[v], g_ref[v], atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(g_x.numpy()[v], g_ref[v], atol=2e-5, rtol=1e-5)
    for py in (py_s, py_x):
        np.testing.assert_allclose(py.numpy(), np.asarray(py_ref), atol=1e-5)
    m_z = step.merge_metrics(step.zero_metrics("cpu"), m_s)  # the identity
    for m in (m_s, m_x, m_z):
        for name in ("examples", "logloss_sum", "correct_sum", "label_sum",
                     "pred_sum", "auc_hist"):
            np.testing.assert_allclose(
                getattr(m, name).numpy(), np.asarray(getattr(m_ref, name)),
                rtol=1e-5, err_msg=name)


def _hot_batch(seed, B=250, L=12, N=4096):
    """``_batch`` with one hot id in every row's first two slots (500
    slots, a run over several 128-slot tiles), and a stream that is no
    multiple of the 1024-slot granule, so the sorted stream has pads."""
    b = _batch(seed, B=B, L=L, N=N)
    b.ids[:, :2] = 7
    b.vals[:, :2] = np.random.default_rng(seed).normal(size=(B, 2))
    return b


@pytest.mark.parametrize("K", [4, 16])
def test_segsum_fm_plain_is_the_composition_and_matches_jax(K):
    """FM's fused per-key sums (ops/segsum.py::segsum_fm) on the CPU: bit
    for bit the composition worker_grads_sorted ran before (the gathered
    2 + K row payload, the segment sum, the combine), and through
    worker_grads_sorted within float association of JAX's scatter
    ``worker_grads``, on a batch with pad slots and a hot key."""
    from difacto_tpu_torch.ops import segsum

    N = 4096
    pb = prep_batch(_hot_batch(11 + K), N)
    ss = build_sorted_slots(pb.inv, pb.vals)
    bl = pb.vals.size
    assert ss.inv_sorted.shape[0] > bl                      # pad slots
    hot = np.bincount(ss.inv_sorted[:bl]).max()
    assert hot >= 3 * segsum.TILE
    U = pb.uids.shape[0]
    rng = np.random.default_rng(K)
    rows_u = (rng.normal(size=(U, 1 + K)) * 0.1).astype(np.float32)
    B = pb.vals.shape[0]
    d = T(rng.normal(size=B).astype(np.float32))
    S = T(rng.normal(size=(B, K)).astype(np.float32))
    x_s, bidx, lanes = T(ss.x_sorted), T(ss.bidx), T(ss.inv_sorted)
    got = segsum.segsum_fm(d, S, x_s, bidx, lanes, T(rows_u))
    g = torch.cat([d[:, None], S], dim=1).index_select(0, bidx)
    dw = g[:, 0] * x_s
    payT = torch.cat([dw[None], (dw * x_s)[None], (dw[:, None] * g[:, 1:]).T])
    segs = segsum.segsum_sorted_plain(payT.contiguous(), lanes, U)
    want = torch.cat([segs[:1], segs[2:] - T(rows_u).T[1:] * segs[1][None]])
    assert got.shape == (1 + K, U)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    untouched = np.bincount(ss.inv_sorted, minlength=U) == 0
    assert bool((got[:, T(untouched)] == 0).all())

    jloc = JLocalized(uids=jnp.asarray(pb.uids), inv=jnp.asarray(pb.inv),
                      counts=jnp.asarray(pb.ucounts),
                      valid=jnp.asarray(pb.valid))
    g_ref, py_ref, _ = jstep.worker_grads(
        jnp.asarray(rows_u), jloc, jnp.asarray(pb.vals),
        jnp.asarray(pb.labels), jnp.asarray(pb.mask))
    loc = Localized(uids=T(pb.uids), inv=T(pb.inv), counts=T(pb.ucounts),
                    valid=T(pb.valid))
    g_s, py_s, _ = step.worker_grads_sorted(
        T(rows_u), loc, T(pb.vals), T(pb.labels), T(pb.mask),
        (x_s, bidx, lanes))
    v = pb.valid
    np.testing.assert_allclose(g_s.numpy().T[v], np.asarray(g_ref)[v],
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(py_s.numpy(), np.asarray(py_ref), atol=1e-5)


def _jprep(b, n):
    """JAX's prep of the same batch (its Batch also carries libffm
    fields, which the port's does not)."""
    return jprep_batch(JBatch(b.ids, b.vals, b.labels, b.mask), n)


def _kw(K, extra=()):
    return [("batch_size", "256"), ("num_bits", "12"),
            ("max_nnz_per_row", "12"), ("V_dim", str(K)), ("l1", "0.1"),
            ("lr_eta", "0.1"), ("V_lr_eta", "0.05"), *extra]


def _start_state(K, seed=7):
    """A NumPy start state both stores are given (torch cannot draw
    jax.random's bits)."""
    rng = np.random.default_rng(seed)
    n = 1 << 12
    z = np.zeros(n, np.float32)
    return {"w": z, "z": z, "n": z, "cnt": z,
            "V": rng.uniform(-0.01, 0.01, (K, n)).astype(np.float32),
            "nV": np.zeros((K, n), np.float32)}


@pytest.mark.parametrize(
    "K,extra",
    [
        (4, ()),
        (0, ()),
        (4, (("w_updater", "adagrad"), ("V_updater", "sgd"))),
        (4, (("w_updater", "sgd"), ("tail_feature_filter", "2"))),
    ],
)
def test_local_store_matches_jax_xla_path(K, extra):
    N = 1 << 12
    jcfg = JConfig.from_kwargs(_kw(K, extra) + [("kernel", "xla"),
                                                ("segsum", "scatter")])
    cfg = Config.from_kwargs(_kw(K, extra))
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    _five_steps_and_eval(jstore, store, N)


def _five_steps_and_eval(jstore, store, N):
    """Five prepped train steps of both stores from one NumPy state, then
    an eval batch (leaves atol 2e-5 rtol 1e-5; logloss rtol 1e-5)."""
    p = store.param
    s0 = _start_state(p.V_dim)
    if p.tail_feature_filter:
        # counts from a count pass, so the tail filter masks some rows
        s0["cnt"] = np.random.default_rng(1).integers(0, 4, N).astype(
            np.float32)
    jst = jstore.place_state(JFMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(5):
        b = _batch(s)
        jst, jm = jstore.train_step_prepped(jst, _jprep(b, N))
        st, m = store.train_step_prepped(st, prep_batch(b, N))
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
    ref, got = fm_leaves(jst), state_to_numpy(st)
    for name in ("w", "z", "n", "V", "nV", "cnt"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    b = _batch(9)
    jm, jpy = jstore.eval_step_prepped(jst, _jprep(b, N))
    m, py = store.eval_step_prepped(st, prep_batch(b, N))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(m.auc_hist.numpy(), np.asarray(jm.auc_hist))


@pytest.mark.parametrize(
    "K,extra",
    [
        (4, (("kernel", "pallas"),)),
        (0, (("kernel", "pallas"),)),
        (4, (("kernel", "pallas"), ("segsum", "sorted"))),
        (4, (("kernel", "pallas"), ("segsum", "sorted"),
             ("w_updater", "sgd"), ("tail_feature_filter", "2"))),
        (4, (("kernel", "pairs"), ("segsum", "scatter"))),
    ],
)
def test_local_store_kernel_paths_match_jax(K, extra):
    """The whole-table sweep (kernel=pallas, with the scatter or the
    sorted backward) and the pair kernels with the scatter backward,
    against JAX's LocalStore on the same path with its Pallas kernels in
    interpret mode."""
    N = 1 << 12
    jcfg = JConfig.from_kwargs(_kw(K, extra))
    cfg = Config.from_kwargs(_kw(K, extra))
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg, interpret=True)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.pallas == jstore.pallas
    assert store.sorted_grads == jstore.sorted_grads
    _five_steps_and_eval(jstore, store, N)


@pytest.mark.parametrize(
    "K,extra",
    [
        (4, ()),
        (0, ()),
        (4, (("w_updater", "adagrad"), ("V_updater", "sgd"))),
        (4, (("w_updater", "sgd"), ("tail_feature_filter", "2"))),
        (4, (("segsum", "scatter"), ("V_threshold", "0"))),
    ],
)
def test_local_store_packed_matches_jax_packed(K, extra):
    """``layout=packed`` on the pairs path (the row-major table; on the
    CPU the pull and apply kernels' plain versions over its columns)
    against JAX's LocalStore with ``layout=packed kernel=xla``, from the
    same carried state, and the bits of the port's planar store."""
    N = 1 << 12
    jcfg = JConfig.from_kwargs(_kw(K, extra) + [("kernel", "xla"),
                                                ("layout", "packed")])
    if not any(k == "segsum" for k, _ in extra):
        jcfg.shard.segsum = "scatter"
    cfg = Config.from_kwargs(_kw(K, extra) + [("layout", "packed")])
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.layout == "packed" and not store.pallas
    assert isinstance(store.init_state(0), PackedFMState)
    _five_steps_and_eval(jstore, store, N)
    # the same steps on the planar store: the same bits
    planar = LocalStore(FMUpdater(cfg.model), Config.from_kwargs(
        _kw(K, extra) + [("layout", "planar")]), device="cpu")
    s0 = _start_state(K)
    sp = store.place_state(state_from_numpy(s0))
    sq = planar.place_state(state_from_numpy(s0))
    assert isinstance(sp, PackedFMState) and not isinstance(sq, PackedFMState)
    for s in range(3):
        sp, mp = store.train_step_prepped(sp, prep_batch(_batch(s), N))
        sq, mq = planar.train_step_prepped(sq, prep_batch(_batch(s), N))
        assert float(mp.logloss_sum) == float(mq.logloss_sum)
    a, b = state_to_numpy(sp), state_to_numpy(sq)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert store.stats(sp) == planar.stats(sq)


@pytest.mark.parametrize(
    "K,extra",
    [
        (4, ()),
        (4, (("segsum", "sorted"),)),
        (0, (("segsum", "sorted"),)),
        (4, (("segsum", "sorted"), ("w_updater", "adagrad"),
             ("V_updater", "sgd"))),
        (4, (("segsum", "sorted"), ("w_updater", "sgd"),
             ("tail_feature_filter", "2"))),
        (4, (("V_threshold", "0"),)),
    ],
)
def test_local_store_pallas_packed_matches_jax(K, extra):
    """``kernel=pallas layout=packed`` (the whole-table sweep over the
    row-major table; on the CPU the sweep kernels' plain versions over
    its columns), with either backward, against JAX's LocalStore on
    ``kernel=pallas`` in interpret mode (planar: JAX refuses packed there)
    and on ``kernel=xla layout=packed``, from the same carried state (the
    tolerances of ``_five_steps_and_eval``), and the bits of the port's
    planar sweep store."""
    N = 1 << 12
    kw = _kw(K, extra) + [("kernel", "pallas")]
    cfg = Config.from_kwargs(kw + [("layout", "packed")])
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.layout == "packed" and store.pallas
    assert isinstance(store.init_state(0), PackedFMState)
    jcfg = JConfig.from_kwargs(kw)
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg, interpret=True)
    assert store.sorted_grads == jstore.sorted_grads
    _five_steps_and_eval(jstore, store, N)
    jcfg = JConfig.from_kwargs(_kw(K, extra) + [("kernel", "xla"),
                                                ("layout", "packed")])
    _five_steps_and_eval(JLocalStore(JFMUpdater(jcfg.model), jcfg), store, N)
    # the same steps on the planar sweep store: the same bits
    planar = LocalStore(FMUpdater(cfg.model), Config.from_kwargs(
        kw + [("layout", "planar")]), device="cpu")
    assert planar.layout == "planar" and planar.pallas
    s0 = _start_state(K)
    sp = store.place_state(state_from_numpy(s0))
    sq = planar.place_state(state_from_numpy(s0))
    assert isinstance(sp, PackedFMState) and not isinstance(sq, PackedFMState)
    for s in range(3):
        sp, mp = store.train_step_prepped(sp, prep_batch(_batch(s), N))
        sq, mq = planar.train_step_prepped(sq, prep_batch(_batch(s), N))
        assert float(mp.logloss_sum) == float(mq.logloss_sum)
    a, b = state_to_numpy(sp), state_to_numpy(sq)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("kernel,V_dim,want", [("auto", 4, "packed"),
                                               ("auto", 0, "planar"),
                                               ("pallas", 4, "packed"),
                                               ("pallas", 0, "packed")])
def test_layout_auto_resolves_as_measured_on_both_table_paths(kernel, V_dim,
                                                              want):
    cfg = Config.from_kwargs(_kw(V_dim) + [("kernel", kernel)])
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.layout == want
    assert isinstance(store.init_state(0), PackedFMState) == (want == "packed")


def test_local_store_packed_count_step_matches_jax():
    N = 1 << 12
    jcfg = JConfig.from_kwargs(_kw(4) + [("kernel", "xla"),
                                         ("layout", "packed")])
    cfg = Config.from_kwargs(_kw(4) + [("layout", "packed")])
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    s0 = _start_state(4)
    jst = jstore.place_state(JFMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(3):
        ids = _batch(s).ids
        jst = jstore.count_step(jst, jnp.asarray(ids))
        st = store.count_step(st, ids)
    assert isinstance(st, PackedFMState)
    np.testing.assert_array_equal(state_to_numpy(st)["cnt"],
                                  np.asarray(fm_leaves(jst).cnt))
    assert jax.device_get(jstore.stats(jst))["nnz_V"] == store.stats(st)[
        "nnz_V"]


def test_local_store_count_step_matches_jax():
    N = 1 << 12
    jcfg = JConfig.from_kwargs(_kw(4) + [("kernel", "xla")])
    cfg = Config.from_kwargs(_kw(4))
    jstore = JLocalStore(JFMUpdater(jcfg.model), jcfg)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    s0 = _start_state(4)
    jst = jstore.place_state(JFMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    for s in range(3):
        ids = _batch(s).ids
        jst = jstore.count_step(jst, jnp.asarray(ids))
        st = store.count_step(st, ids)
    np.testing.assert_array_equal(state_to_numpy(st)["cnt"],
                                  np.asarray(fm_leaves(jst).cnt))
    assert jax.device_get(jstore.stats(jst))["nnz_V"] == store.stats(st)[
        "nnz_V"]
