"""The port's device localize (``host_localize=0``, ops/localize.py)
against the JAX package.

``localize``'s five outputs equal JAX's exactly (uids, inv, counts,
valid and the overflow count, dtypes included), the sentinel lane and
the aliasing of dropped ids under overflow among them. The raw-batch
train and eval steps of the port's store (``kernel=xla`` on each layout,
and ``kernel=pallas``, the JAX side's Pallas kernels in interpret mode)
hold every leaf within rel 1e-5 / abs 1e-6 of the JAX store's and count
the same dropped ids; the learner with ``host_localize=0`` trains within
logloss rel 1e-5 and AUC abs 1e-5 of the JAX learner.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fm_leaves

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.ops.localize import localize as jlocalize
from difacto_tpu.parallel.store import LocalStore as JLocalStore
from difacto_tpu.updaters import updater as jupd
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.prep import prep_batch
from difacto_tpu_torch.data.batch_iter import Batch
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.ops.localize import localize
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import FMUpdater
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

NB = 12
N = 1 << NB
LEAVES = ("w", "z", "n", "V", "nV", "cnt")
FIELDS = ("uids", "inv", "counts", "valid", "overflow")


def _ids(seed, B, L, n, pad_frac):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < pad_frac] = -1
    return ids


@pytest.mark.parametrize("ids,num_rows,U", [
    (np.array([[5, 3, 5, -1], [7, 3, -1, -1]], np.int32), 16, 8),
    (np.array([[9, 1, 4, 1]], np.int32), 16, 4),        # exact fit
    (np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32), 16, 4),  # overflow 4
    (np.array([[1, 2, 2, -1]], np.int32), 16, 4),       # pads never overflow
    (np.array([[1, 2, 3, -1, -1]], np.int32), 16, 3),   # full, with pads
    (np.full((3, 4), -1, np.int32), 16, 4),             # all pads
    (_ids(0, 8, 16, 50, 0.3), 64, 128),
    (_ids(1, 64, 12, 4096, 0.1), 4096, 64 * 12),
    (_ids(2, 64, 12, 200, 0.1), 256, 100),              # overflow, pads
    (_ids(3, 4, 8, 30, 0.0), 32, 32),
])
def test_localize_matches_jax(ids, num_rows, U):
    ref = jlocalize(jnp.asarray(ids), num_rows, U)
    got = localize(torch.from_numpy(ids), num_rows, U)
    for name in FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        np.testing.assert_array_equal(b, a, err_msg=name)
        assert b.dtype == a.dtype, name
    # the port's own contract: sorted uids, sentinel-padded; without
    # overflow the inverse rebuilds every real id, and pad slots point at
    # the sentinel lane when the lanes leave one (else they alias the
    # last lane, as dropped ids do, with zero values)
    uids, inv = got.uids.numpy(), got.inv.numpy()
    valid = got.valid.numpy()
    assert (np.diff(uids) >= 0).all()
    assert (uids[~valid] == num_rows).all()
    flat = ids.reshape(-1)
    if float(got.overflow) == 0:
        real = flat >= 0
        np.testing.assert_array_equal(uids[inv][real], flat[real])
        if not valid.all():
            assert (uids[inv][~real] == num_rows).all()
        assert float(got.counts.sum()) == float(real.sum())


def test_localize_matches_host_prep():
    """On a batch that fits, device localize's uids, counts and inverse
    are host prep's, in fewer lanes (prep rounds up a bucket ladder)."""
    ids = _ids(4, 128, 10, N, 0.1)
    b = Batch(ids, np.ones(ids.shape, np.float32), np.ones(128, np.float32),
              np.ones(128, np.float32))
    pb = prep_batch(b, N)
    loc = localize(torch.from_numpy(ids), N, ids.size)
    n = int(loc.valid.sum())
    assert n == int(pb.valid.sum())
    np.testing.assert_array_equal(loc.uids.numpy()[:n], pb.uids[:n])
    np.testing.assert_array_equal(loc.counts.numpy()[:n], pb.ucounts[:n])
    real = ids.reshape(-1) >= 0
    np.testing.assert_array_equal(loc.inv.numpy()[real], pb.inv[real])


def _kw(K, extra=()):
    return [("batch_size", "256"), ("num_bits", str(NB)),
            ("max_nnz_per_row", "12"), ("V_dim", str(K)), ("l1", "0.1"),
            ("lr_eta", "0.1"), ("V_lr_eta", "0.05"), ("host_localize", "0"),
            *extra]


def _start_state(K, seed=7):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=N) * 0.1).astype(np.float32),
            "z": rng.normal(size=N).astype(np.float32),
            "n": rng.random(N).astype(np.float32),
            "cnt": rng.integers(0, 4, N).astype(np.float32),
            "V": rng.uniform(-0.1, 0.1, (K, N)).astype(np.float32),
            "nV": rng.random((K, N)).astype(np.float32)}


def _raw(seed, B=256, L=12):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, (B, L)) % N).astype(np.int32)
    ids[rng.random((B, L)) < 0.1] = -1
    vals = np.where(ids < 0, 0.0, rng.normal(size=(B, L))).astype(np.float32)
    return (ids, vals, (rng.random(B) > 0.5).astype(np.float32),
            np.ones(B, np.float32))


@pytest.mark.parametrize("K,extra", [
    (4, (("kernel", "xla"),)),
    (4, (("kernel", "xla"), ("layout", "planar"))),
    (4, (("kernel", "xla"), ("layout", "packed"))),
    (0, ()),
    (4, (("kernel", "xla"), ("unique_size", "300"))),
    (4, (("kernel", "pallas"),)),
    (4, (("kernel", "pallas"), ("layout", "planar"), ("unique_size", "300"))),
])
def test_device_localized_steps_match_jax(K, extra):
    """Five raw-batch train steps and an eval step from one state; a
    ``unique_size`` under the batch's distinct ids drops some, counted
    alike in ``dropped_ids`` (and trained alike on the aliased lane)."""
    kw = _kw(K, extra)
    jcfg, cfg = JConfig.from_kwargs(kw), Config.from_kwargs(kw)
    pallas = dict(extra).get("kernel") == "pallas"
    jstore = JLocalStore(jupd.FMUpdater(jcfg.model), jcfg, interpret=pallas)
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    assert store.kernel == ("pallas" if pallas else "xla")
    s0 = _start_state(K)
    jst = jstore.place_state(jupd.FMState(**s0))
    st = store.place_state(state_from_numpy(s0))
    dropped = 0.0
    for s in range(5):
        args = _raw(s)
        jst, jm = jstore.train_step(jst, *args)
        st, m = store.train_step(st, *args)
        np.testing.assert_allclose(float(m.logloss_sum),
                                   float(jm.logloss_sum), rtol=1e-5)
        assert float(m.dropped_ids) == float(jm.dropped_ids)
        dropped += float(m.dropped_ids)
    assert (dropped > 0) == ("unique_size" in dict(extra))
    ref, got = fm_leaves(jst), state_to_numpy(st)
    for name in LEAVES:
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jm, jpy = jstore.eval_step(jst, *_raw(99))
    m, py = store.eval_step(st, *_raw(99))
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), rtol=1e-5,
                               atol=2e-5)
    assert float(m.dropped_ids) == float(jm.dropped_ids)


def test_overflow_surfaces_in_step_metrics():
    """tests/test_localize.py's case in the port: 32 distinct ids into 4
    lanes drop 28."""
    cfg = Config.from_kwargs([("batch_size", "4"), ("num_bits", "8"),
                              ("max_nnz_per_row", "8"), ("V_dim", "0"),
                              ("unique_size", "4"), ("host_localize", "0")])
    store = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    ids = np.random.default_rng(0).permutation(
        np.arange(32, dtype=np.int32)).reshape(4, 8)
    ones = np.ones(4, np.float32)
    _, m = store.train_step(store.init_state(0), ids,
                            np.ones((4, 8), np.float32), ones, ones)
    assert float(m.dropped_ids) == 28.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("loc")
    write_libsvm(make_ctr_data(4000, num_fields=8, vocab_per_field=200,
                               seed=1), str(d / "tr.svm"))
    write_libsvm(make_ctr_data(1000, num_fields=8, vocab_per_field=200,
                               seed=2), str(d / "va.svm"))
    return d


@pytest.mark.parametrize("kernel,cache", [("xla", "0"), ("pallas", "1")])
def test_device_localize_learner_matches_jax(data, tmp_path, kernel, cache):
    """The learner with ``host_localize=0`` (raw batches placed, cached on
    the device with ``cache_batches``) against the JAX learner on the
    same path, from one start state: logloss rel 1e-5, AUC abs 1e-5; then
    ``task=predict`` on the port's checkpoint scores as JAX's predict."""
    from difacto_tpu_torch import cli

    rng = np.random.default_rng(3)
    n = 1 << 13
    s0 = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s0["V"] = rng.uniform(-0.01, 0.01, (4, n)).astype(np.float32)
    s0["nV"] = np.zeros((4, n), np.float32)
    start = str(tmp_path / "start")
    jcheckpoint.save(start, jupd.FMState(**s0), {"epoch": 0})
    kw = [("data_in", str(data / "tr.svm")), ("data_val", str(data / "va.svm")),
          ("batch_size", "512"), ("num_bits", "13"), ("max_nnz_per_row", "8"),
          ("V_dim", "4"), ("lr_eta", "0.1"), ("l1", "0.1"),
          ("V_lr_eta", "0.05"), ("max_num_epochs", "2"), ("store", "local"),
          ("report_interval", "0"), ("host_localize", "0"),
          ("kernel", kernel), ("model_in", start), ("cache_batches", cache),
          ("cache_on_device", cache)]
    jva = JSGDLearner(JConfig.from_kwargs(
        kw + [("interpret", str(int(kernel == "pallas")))])).run()
    model = str(tmp_path / "model")
    learner = SGDLearner(Config.from_kwargs(kw + [("model_out", model)]),
                         device="cpu")
    assert learner.store.kernel == kernel
    va = learner.run()
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    assert va.exact_auc > 0.57
    out = str(tmp_path / "pred.txt")
    args = [f"{k}={v}" for k, v in kw if k not in ("model_in", "data_in")]
    assert cli.main(args + [f"data_in={data / 'va.svm'}", "task=predict",
                            f"model_in={model}", f"pred_out={out}"],
                    device="cpu") == 0
    jkw = [(k, v) for k, v in kw if k not in ("model_in", "data_in")]
    jpy, _ = JSGDLearner(JConfig.from_kwargs(
        jkw + [("model_in", model), ("data_in", str(data / "va.svm")),
               ("interpret", str(int(kernel == "pallas")))])).predict(
        str(data / "va.svm"))
    np.testing.assert_allclose(np.loadtxt(out), jpy, rtol=2e-5, atol=1e-5)
