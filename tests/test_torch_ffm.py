"""The port's field-aware FM (loss=ffm) against the JAX package.

Same NumPy inputs through both packages on the CPU: the FFM loss (dense
and blocked, slot-position and explicit fields), the worker step's
scatter and sorted backward, LocalStore steps on every table path and
layout against JAX's LocalStore with its Pallas kernels in interpret
mode, the learner on a small FFM recipe, checkpoints and predictions in
both directions, and the config's activation-cap rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fm_leaves

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.batch_iter import Batch as JBatch
from difacto_tpu.data.prep import build_sorted_slots as jbuild_sorted_slots
from difacto_tpu.data.prep import prep_batch as jprep_batch
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners import step as jstep
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.models import losses as jlosses
from difacto_tpu.ops.localize import Localized as JLocalized
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
from difacto_tpu_torch.learners import step
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.models import losses
from difacto_tpu_torch.ops.localize import Localized
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import FMUpdater, PackedFMState
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

T = torch.from_numpy


# -- the loss ----------------------------------------------------------------


def _loss_inputs(B=5, L=11, F=4, k=3, seed=7, explicit=True):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(B, L)).astype(np.float32)
    vals[rng.random((B, L)) < 0.2] = 0.0
    W = rng.normal(size=(B, L)).astype(np.float32)
    y = (rng.random(B) > 0.5).astype(np.float32)
    m = np.ones(B, np.float32)
    m[-1] = 0.0
    if not explicit:
        F = L
    V4 = rng.normal(size=(B, L, F, k)).astype(np.float32)
    fields = rng.integers(0, F, (B, L)).astype(np.int32) if explicit else None
    return vals, W, V4, y, m, fields


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("block", [0, 1, 4, 11, 16])
def test_ffm_loss_grad_matches_jax(explicit, block):
    """Dense (block 0, and blocks >= L, which stay dense) and blocked (4
    does not divide L = 11), slot-position fields (F = L) and explicit
    fields: py, dW, dV4, loss and correct at rel 1e-5 (atol 1e-6 for the
    entries near 0); the eval forward gives the loss's py bit for bit."""
    vals, W, V4, y, m, fields = _loss_inputs(explicit=explicit)
    jf, jg = jlosses.ffm_loss_grad(
        *map(jnp.asarray, (vals, W, V4, y, m)),
        fields=None if fields is None else jnp.asarray(fields), block=block)
    tfields = None if fields is None else T(fields)
    tf, tg = losses.ffm_loss_grad(*map(T, (vals, W, V4, y, m)),
                                  fields=tfields, block=block)
    np.testing.assert_allclose(tf.py.numpy(), np.asarray(jf.py), rtol=1e-5,
                               atol=1e-6)
    for name in ("dW", "dV", "loss", "correct"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert tg.dV.shape == V4.shape and tf.S.shape == (vals.shape[0], 0)
    assert torch.equal(losses.ffm_predict(T(vals), T(W), T(V4), tfields,
                                          block), tf.py)


# -- the worker step ---------------------------------------------------------


def _batch(seed, B=96, L=6, N=4096, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < pad_frac] = -1
    vals = np.where(ids < 0, 0.0, rng.normal(size=(B, L))).astype(np.float32)
    return Batch(ids, vals, (rng.random(B) > 0.5).astype(np.float32),
                 np.ones(B, np.float32))


@pytest.mark.parametrize(
    "backward,block,num_fields",
    [("scatter", 0, 0), ("scatter", 4, 0), ("scatter", 0, 3),
     ("scatter", 4, 3), ("sorted", 0, 0), ("sorted", 4, 0)],
)
def test_ffm_worker_grads_match_jax(backward, block, num_fields):
    """The scatter backward (``index_add_``) against JAX's
    ``worker_grads``, explicit fields included, and the sorted backward
    (the per-slot payload gathered by ``slot_sorted``, then the segment
    sum) against JAX's ``worker_grads_sorted`` with its segment-sum
    kernel in interpret mode: per-key sums on the real lanes atol 2e-5
    rtol 1e-5, margins atol 1e-5, metrics rtol 1e-5. The eval forward
    gives the same margins and metrics."""
    N, k, L = 4096, 2, 6
    F = num_fields or L
    K = F * k
    pb = prep_batch(_batch(5), N)
    U = pb.uids.shape[0]
    rng = np.random.default_rng(0)
    rows_u = (rng.normal(size=(U, 1 + K)) * 0.3).astype(np.float32)
    fields = (rng.integers(0, F, pb.vals.shape).astype(np.int32)
              if num_fields else None)
    kw = dict(loss="ffm", num_fields=num_fields, ffm_block=block)
    jloc = JLocalized(uids=jnp.asarray(pb.uids), inv=jnp.asarray(pb.inv),
                      counts=jnp.asarray(pb.ucounts),
                      valid=jnp.asarray(pb.valid))
    jargs = (jnp.asarray(rows_u), jloc, jnp.asarray(pb.vals),
             jnp.asarray(pb.labels), jnp.asarray(pb.mask))
    jfields = None if fields is None else jnp.asarray(fields)
    loc = Localized(uids=T(pb.uids), inv=T(pb.inv), counts=T(pb.ucounts),
                    valid=T(pb.valid))
    args = (T(rows_u), loc, T(pb.vals), T(pb.labels), T(pb.mask))
    tfields = None if fields is None else T(fields)
    v = pb.valid
    if backward == "scatter":
        g_ref, py_ref, m_ref = jstep.worker_grads(*jargs, fields=jfields,
                                                  **kw)
        got, py, m = step.worker_grads(*args, fields=tfields, **kw)
        got, ref = got.numpy(), np.asarray(g_ref)
    else:
        jss = jbuild_sorted_slots(pb.inv, pb.vals, U, with_slots=True)
        ss = build_sorted_slots(pb.inv, pb.vals, with_slots=True)
        np.testing.assert_array_equal(ss.slot_sorted, jss.slot_sorted)
        np.testing.assert_array_equal(ss.inv_sorted, jss.inv_sorted)
        jdev = tuple(jnp.asarray(a) for a in (
            jss.x_sorted, jss.bidx, jss.inv_sorted, jss.seg_tiles,
            jss.seg_wins, jss.seg_first))
        g_ref, py_ref, m_ref = jstep.worker_grads_sorted(
            *jargs, jdev, slot_s=jnp.asarray(jss.slot_sorted),
            interpret=True, **kw)
        got, py, m = step.worker_grads_sorted(
            *args, (T(ss.x_sorted), T(ss.bidx), T(ss.inv_sorted)),
            slot_s=T(ss.slot_sorted), **kw)
        assert got.shape == (1 + K, U)
        got, ref = got.numpy().T, np.asarray(g_ref).T
    np.testing.assert_allclose(got[v], ref[v], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(py.numpy(), np.asarray(py_ref), atol=1e-5)
    py_f, m_f = step.worker_forward(*args, fields=tfields, **kw)
    np.testing.assert_allclose(py_f.numpy(), np.asarray(py_ref), atol=1e-5)
    for mm in (m, m_f):
        for name in ("examples", "logloss_sum", "correct_sum", "label_sum",
                     "pred_sum", "auc_hist"):
            np.testing.assert_allclose(
                getattr(mm, name).numpy(), np.asarray(getattr(m_ref, name)),
                rtol=1e-5, err_msg=name)


# -- LocalStore --------------------------------------------------------------


def _kw(extra=()):
    return [("batch_size", "96"), ("num_bits", "12"),
            ("max_nnz_per_row", "6"), ("V_dim", "2"), ("loss", "ffm"),
            ("l1", "0.1"), ("lr_eta", "0.1"), ("V_lr_eta", "0.05"),
            ("V_threshold", "1"), *extra]


def _start_state(K, seed=7):
    rng = np.random.default_rng(seed)
    n = 1 << 12
    return {"w": np.zeros(n, np.float32), "z": np.zeros(n, np.float32),
            "n": np.zeros(n, np.float32),
            "cnt": rng.integers(0, 3, n).astype(np.float32),
            "V": rng.uniform(-0.3, 0.3, (K, n)).astype(np.float32),
            "nV": np.zeros((K, n), np.float32)}


@pytest.mark.parametrize(
    "kernel,layout,segsum,block",
    [("pairs", "planar", "sorted", 0), ("pairs", "packed", "sorted", 0),
     ("pairs", "planar", "scatter", 0), ("pairs", "packed", "scatter", 0),
     ("pairs", "packed", "sorted", 4), ("pallas", "planar", "auto", 0),
     ("pallas", "packed", "auto", 0), ("pallas", "packed", "sorted", 0)],
)
def test_ffm_local_store_matches_jax(kernel, layout, segsum, block):
    """Three FFM train steps of the port's LocalStore, then an eval
    batch, on the pair kernels and the whole-table sweep, over planar
    leaves and the row-major table, with the sorted and the scatter
    backward, dense and blocked (4 does not divide L = 6), against JAX's
    LocalStore on the same kernel path with its Pallas kernels in
    interpret mode (planar: it takes no packed table with them), from one
    NumPy state: leaves atol 2e-5 rtol 1e-5, logloss rtol 1e-5, margins
    atol 2e-5 rtol 1e-5, the AUC histogram equal."""
    N, L, k = 1 << 12, 6, 2
    extra = [("kernel", kernel), ("segsum", segsum),
             ("ffm_block_size", str(block))]
    jcfg = JConfig.from_kwargs(_kw(extra))
    cfg = Config.from_kwargs(_kw(extra + [("layout", layout)]))
    assert cfg.model.ffm_block_size == jcfg.model.ffm_block_size == block
    p = cfg.effective_model_param()
    assert p.V_dim == jcfg.effective_model_param().V_dim == L * k
    jstore = JLocalStore(JFMUpdater(jcfg.effective_model_param()), jcfg,
                         interpret=True)
    store = LocalStore(FMUpdater(p), cfg, device="cpu")
    assert store.layout == layout
    assert (store.pallas, store.sorted_grads) == (jstore.pallas,
                                                 jstore.sorted_grads)
    s0 = _start_state(p.V_dim)
    jst = jstore.place_state(JFMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    assert isinstance(st, PackedFMState) == (layout == "packed")
    for s in range(3):
        b = _batch(s)
        jst, jm = jstore.train_step_prepped(
            jst, jprep_batch(JBatch(b.ids, b.vals, b.labels, b.mask), N))
        st, m = store.train_step_prepped(st, prep_batch(b, N))
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
    ref, got = fm_leaves(jst), state_to_numpy(st)
    for name in ("w", "z", "n", "V", "nV", "cnt"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    b = _batch(9)
    jm, jpy = jstore.eval_step_prepped(
        jst, jprep_batch(JBatch(b.ids, b.vals, b.labels, b.mask), N))
    m, py = store.eval_step_prepped(st, prep_batch(b, N))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(m.auc_hist.numpy(), np.asarray(jm.auc_hist))


# -- the learner, checkpoints and predictions --------------------------------

BITS, L, K_FFM = 13, 6, 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ffm")
    write_libsvm(make_ctr_data(3000, num_fields=L, vocab_per_field=100,
                               seed=1), str(d / "train.svm"))
    write_libsvm(make_ctr_data(1000, num_fields=L, vocab_per_field=100,
                               seed=2), str(d / "val.svm"))
    return d


def _recipe(d, *extra):
    return [
        ("data_in", str(d / "train.svm")), ("data_val", str(d / "val.svm")),
        ("batch_size", "512"), ("num_bits", str(BITS)),
        ("max_nnz_per_row", str(L)), ("V_dim", str(K_FFM)), ("loss", "ffm"),
        ("lr_eta", "0.1"), ("l1", "0.1"), ("V_lr_eta", "0.05"),
        ("max_num_epochs", "2"), ("store", "local"), *extra,
    ]


def _ffm_state(seed, trained=False):
    rng = np.random.default_rng(seed)
    n, K = 1 << BITS, L * K_FFM
    s = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s["V"] = rng.uniform(-0.01, 0.01, (K, n)).astype(np.float32)
    s["nV"] = np.zeros((K, n), np.float32)
    if trained:
        s["w"] = (rng.normal(size=n) * (rng.random(n) < 0.3)).astype(
            np.float32)
        s["V"] = rng.normal(size=(K, n)).astype(np.float32) * 0.2
        s["cnt"] = rng.integers(0, 5, n).astype(np.float32)
    return s


@pytest.mark.parametrize("layout", ["auto", "planar"])
def test_ffm_recipe_matches_jax(data, tmp_path, layout):
    """Two epochs of a small FFM recipe (6 fields by slot position, k = 2,
    so 12 factors a feature) from one start state: the port's default
    path (pairs, sorted backward, row-major table) and its planar leaves
    against the JAX learner on its default CPU path: validation logloss
    rel 1e-5, AUC abs 1e-5."""
    start = str(tmp_path / "start")
    jcheckpoint.save(start, JFMState(**_ffm_state(3)), {"epoch": 0})
    kw = _recipe(data, ("model_in", start))
    jva = JSGDLearner(JConfig.from_kwargs(kw)).run()
    learner = SGDLearner(Config.from_kwargs(kw + [("layout", layout)]),
                         device="cpu")
    assert learner.store.sorted_grads and learner.store.loss == "ffm"
    assert isinstance(learner.state, PackedFMState) == (layout == "auto")
    va = learner.run()
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.55


def _predict_port(data, model, out):
    rc = cli.main([f"data_in={data / 'val.svm'}", "batch_size=512",
                   f"num_bits={BITS}", f"max_nnz_per_row={L}",
                   f"V_dim={K_FFM}", "loss=ffm", "task=predict",
                   f"model_in={model}", f"pred_out={out}"], device="cpu")
    assert rc == 0
    return np.loadtxt(out)


def _predict_jax(data, model):
    cfg = JConfig.from_kwargs([
        ("data_in", str(data / "val.svm")), ("batch_size", "512"),
        ("num_bits", str(BITS)), ("max_nnz_per_row", str(L)),
        ("V_dim", str(K_FFM)), ("loss", "ffm"), ("model_in", model),
        ("max_num_epochs", "0"), ("store", "local"),
    ])
    py, _ = JSGDLearner(cfg).predict(str(data / "val.svm"))
    return py


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ffm_checkpoints_predict_the_same_across_packages(data, tmp_path,
                                                         writer):
    """An FFM checkpoint (V of F*k = 12 rows) written by either package —
    the port's after a CLI training run, JAX's from a trained-looking
    state — loads in both and scores the same through ``task=predict``
    (pred_out keeps 6 significant digits: rtol 2e-5, atol 1e-5)."""
    model = str(tmp_path / "model")
    if writer == "port":
        rc = cli.main([f"data_in={data / 'train.svm'}", "batch_size=512",
                       f"num_bits={BITS}", f"max_nnz_per_row={L}",
                       f"V_dim={K_FFM}", "loss=ffm", "lr_eta=0.1", "l1=0.1",
                       "V_lr_eta=0.05", "max_num_epochs=1",
                       f"model_out={model}"], device="cpu")
        assert rc == 0
    else:
        jcheckpoint.save(model, JFMState(**{
            k: jnp.asarray(v) for k, v in _ffm_state(4, trained=True).items()
        }), {"epoch": 2})
    host, meta = jcheckpoint.load(model)
    assert host.V.shape == (L * K_FFM, 1 << BITS)
    ref = _predict_jax(data, model)
    got = _predict_port(data, model, tmp_path / "pred.txt")
    assert got.shape == ref.shape == (1000,)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


# -- the config --------------------------------------------------------------


def _ffm_cfg(mk, B, L_, k, extra=()):
    return mk.from_kwargs([("loss", "ffm"), ("batch_size", str(B)),
                           ("max_nnz_per_row", str(L_)), ("V_dim", str(k)),
                           *extra])


@pytest.mark.parametrize("B,L_,k,want", [(4096, 24, 4, 0),
                                         (16384, 256, 16, 8),
                                         (4096, 512, 16, 16),
                                         (8192, 200, 8, 48)])
def test_ffm_auto_block_equals_jax(B, L_, k, want):
    """The activation-cap rule picks JAX's ``ffm_block_size`` (0: dense,
    it fits; else the largest multiple of 8 that fits, at most L), so
    both packages sum the cross terms in the same blocks; the factor
    width is F*k with F = max_nnz_per_row."""
    cfg, jcfg = _ffm_cfg(Config, B, L_, k), _ffm_cfg(JConfig, B, L_, k)
    assert cfg.model.ffm_block_size == jcfg.model.ffm_block_size == want
    assert (cfg.effective_model_param().V_dim
            == jcfg.effective_model_param().V_dim == k * L_)
    assert not cfg.expects_fields()


@pytest.mark.parametrize("block", [16, 256])
def test_ffm_explicit_block_over_the_cap_fails_at_config_time(block):
    """Where the two packages differ on purpose: the JAX config keeps an
    explicit ``ffm_block_size`` whatever its peak (256 >= L even falls
    back to the dense loss, ~384 GiB here); the port holds it to the cap
    and fails at config time. Under the cap both keep it."""
    assert _ffm_cfg(JConfig, 16384, 256, 16, [(
        "ffm_block_size", str(block))]).model.ffm_block_size == block
    with pytest.raises(ValueError, match="ffm_block_size"):
        _ffm_cfg(Config, 16384, 256, 16, [("ffm_block_size", str(block))])
    assert _ffm_cfg(Config, 1024, 256, 16, [(
        "ffm_block_size", "8")]).model.ffm_block_size == 8


def test_ffm_too_big_even_blocked_raises_in_both():
    for mk in (Config, JConfig):
        with pytest.raises(ValueError, match="O\\(B L\\^2 K\\)"):
            _ffm_cfg(mk, 65536, 1024, 32)


def test_ffm_store_takes_only_the_effective_width():
    """The store's updater must carry the F*k factors of
    ``effective_model_param``; the model param's k alone is refused."""
    cfg = Config.from_kwargs(_kw())
    with pytest.raises(ValueError, match="effective_model_param"):
        LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    store = LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu")
    assert store.init_state(0).k == 12
