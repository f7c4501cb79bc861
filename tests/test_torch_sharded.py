"""The port's sharded store (ShardedStore over torch.distributed) and K1,
against the JAX package.

The store's cases (tests/torch_sharded_ranks.py) run in S gloo processes
on the CPU (``difacto_tpu_torch.parallel.launch``: one group for S = 2,
one for S = 3, each running many cases under a join timeout and a group
timeout, so a deadlock fails a test) and, at S = 1, in this process with
no group. Each is held against the JAX ShardedStore on an S-device CPU
mesh (tests/conftest.py gives eight) from the same global batches and the
same start state, within the JAX package's local-against-sharded
tolerance (tests/test_store_equiv.py:55: the table's leaves rtol and atol
2e-4, logloss rtol 1e-4); the eval scores within its eval tolerance
(rtol and atol 1e-5); examples, dropped ids and the capacity pin exactly.
The JAX store runs its Pallas kernels (pairs, pallas) in interpret mode.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from difacto_tpu.config import Config as JConfig
from difacto_tpu.config import FMParam as JFMParam
from difacto_tpu.data.prep import prep_batch_sharded as jprep_sharded
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.learners.sgd import SGDLearner as JSGDLearner
from difacto_tpu.ops import pair_sweep as jps
from difacto_tpu.parallel.store import ShardedStore as JShardedStore
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data import prep
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.ops import pair_sweep
from difacto_tpu_torch.parallel import comm as tcomm
from difacto_tpu_torch.parallel.launch import run_ranks
from difacto_tpu_torch.parallel.store import (LocalStore, ShardedStore,
                                              make_store)
from difacto_tpu_torch.updaters.updater import FMUpdater, pack_state
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy
from helpers import fm_leaves
from test_torch_cuda import (LEAVES, N, port_params, seg_payload, seg_stream,
                             state_np)

torch.set_num_threads(2)

TESTS = str(pathlib.Path(__file__).resolve().parent)
# a group's wall limit (spawn, imports, every case of the group) and the
# collectives' own limit: both far above a healthy run (~10 s)
GROUP_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 240.0, 60.0


# -- the store's cases -------------------------------------------------------


def jax_case(name: str, S: int) -> dict:
    """The JAX ShardedStore's run of case ``name`` on an S-device mesh,
    the steps of torch_sharded_ranks.run_case."""
    opts = R.CASES[name]
    kernel = opts.get("kernel")
    # the JAX store runs its table kernels on planar leaves only
    kw = [(k, v) for k, v in R.config_keys(name, S)
          if not (k == "layout" and kernel in ("pairs", "pallas"))]
    cfg = JConfig.from_kwargs(kw)
    mesh = jax.make_mesh((S,), ("shard",), devices=jax.devices()[:S])
    st = JShardedStore(JFMUpdater(cfg.effective_model_param()), cfg,
                       mesh=mesh, interpret=kernel in ("pairs", "pallas"))
    k = cfg.effective_model_param().V_dim
    state = st.place_state(JFMState(**{
        n: jnp.asarray(v) for n, v in R.start_state(k).items()}))
    batches = R.case_batches(name)
    if opts.get("count"):
        for b in batches:
            state = st.count_step(state, st.shard_batch(
                b.ids, b.vals, b.labels, b.mask)[0])
    metrics = []

    def train_pass():
        nonlocal state
        for b in batches:
            if opts.get("raw"):
                state, m = st.train_step(state, *st.shard_batch(
                    b.ids, b.vals, b.labels, b.mask))
            else:
                state, m = st.train_step_prepped(state, jprep_sharded(
                    b, st.num_rows, S, buckets=R.BUCKETS))
            metrics.append([float(m.examples), float(m.logloss_sum),
                            float(m.dropped_ids)])

    train_pass()
    pin = 0
    if opts.get("pin"):
        pin = st.pin_capacity()
        train_pass()
    b = batches[0]
    if opts.get("raw"):
        m, py = st.eval_step(state, *st.shard_batch(b.ids, b.vals, b.labels,
                                                    b.mask))
    else:
        m, py = st.eval_step_prepped(state, jprep_sharded(
            b, st.num_rows, S, buckets=R.BUCKETS))
    h = fm_leaves(state)
    stats = st.stats(state)
    return {**{n: np.asarray(getattr(h, n)) for n in LEAVES},
            "metrics": np.asarray(metrics, np.float64),
            "eval": np.asarray([float(m.examples), float(m.logloss_sum),
                                float(m.dropped_ids)]),
            "py": np.asarray(py),
            "stats": np.asarray([float(stats["nnz_w"]),
                                 float(stats["nnz_V"])]),
            "pin": np.asarray(pin), "num_rows": np.asarray(st.num_rows)}


_GROUPS: dict[int, pathlib.Path] = {}


def group_results(S: int, tmp_path_factory) -> pathlib.Path:
    """Every case of group S, run once per module by S gloo processes."""
    if S not in _GROUPS:
        out = tmp_path_factory.mktemp(f"sharded_s{S}")
        run_ranks("torch_sharded_ranks:run", S, [str(out), str(S)],
                  timeout=GROUP_TIMEOUT_S, path=TESTS,
                  group_timeout=COLLECTIVE_TIMEOUT_S)
        _GROUPS[S] = out
    return _GROUPS[S]


def assert_case_matches(got: dict, ref: dict, name: str) -> None:
    assert int(got["num_rows"]) == int(ref["num_rows"])
    for leaf in LEAVES:
        a, b = got[leaf], ref[leaf]
        assert a.shape == b.shape, leaf
        if a.size:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{name} {leaf}")
    gm, rm = got["metrics"], ref["metrics"]
    assert gm.shape == rm.shape
    np.testing.assert_array_equal(gm[:, 0], rm[:, 0])  # examples
    np.testing.assert_allclose(gm[:, 1], rm[:, 1], rtol=1e-4)  # logloss
    np.testing.assert_array_equal(gm[:, 2], rm[:, 2])  # dropped ids
    assert got["eval"][0] == ref["eval"][0]
    np.testing.assert_allclose(got["eval"][1], ref["eval"][1], rtol=1e-4)
    assert got["eval"][2] == ref["eval"][2]
    np.testing.assert_allclose(got["py"], ref["py"], rtol=1e-5, atol=1e-5)
    # nnz_V counts rows past the V gate (exact counts); nnz_w may flip a
    # weight sitting on the l1 threshold
    assert got["stats"][1] == ref["stats"][1]
    assert abs(got["stats"][0] - ref["stats"][0]) <= 1
    assert int(got["pin"]) == int(ref["pin"])


_RANKED = [(S, name) for S in sorted(R.GROUPS) for name in R.GROUPS[S]]


@pytest.mark.parametrize("S,name", _RANKED,
                         ids=[f"S{S}-{n}" for S, n in _RANKED])
def test_sharded_ranks_match_jax(S, name, tmp_path_factory):
    """S gloo ranks on the CPU against the JAX store on an S-device
    mesh: pairs (B1, K1), pallas (B5) and xla on planar, packed and
    stacked tables, either backward, FFM (the slot position as field, and
    explicit libffm fields shuffled in the row), Zipf routing, a count
    pass with the tail filter, overflow counted in ``dropped_ids``
    (host-prepped and device-localized), the capacity pin, eval, and at
    S = 3 the padded table."""
    got = dict(np.load(group_results(S, tmp_path_factory) / f"{name}.npz"))
    ref = jax_case(name, S)
    assert_case_matches(got, ref, name)
    if name.endswith("overflow") and S == 2:
        assert got["metrics"][:, 2].sum() > 0  # the case drops ids


_S1 = ("pairs_packed", "pairs_planar_scatter", "pallas_packed",
       "xla_stacked", "xla_raw_overflow", "ffm_pairs")


@pytest.mark.parametrize("name", _S1)
def test_sharded_s1_matches_jax(name):
    """S = 1, no process group: the identity branch (the pairs path is
    LocalStore's) against the JAX store on one device."""
    assert tcomm.Comm().size == 1
    assert_case_matches(R.run_case(name), jax_case(name, 1), name)


@pytest.mark.parametrize("kernel", ["pairs", "pallas", "xla"])
def test_sharded_s1_gives_local_store_bits(kernel):
    """At S = 1 the sharded store trains the LocalStore's floats, bit for
    bit, on every table path (the same kernels in the same order)."""
    kw = R.config_keys("pairs_packed", 1)
    kw = [(k, kernel if k == "kernel" else v) for k, v in kw
          if k != "layout"]
    cfg = Config.from_kwargs(kw)
    cfg_local = Config.from_kwargs([(k, "local" if k == "store" else v)
                                    for k, v in kw])
    upd = FMUpdater(cfg.effective_model_param())
    sh = make_store(upd, cfg, device="cpu")
    lo = make_store(upd, cfg_local, device="cpu")
    assert isinstance(sh, ShardedStore) and type(lo) is LocalStore
    assert (sh.S, sh.num_rows, sh.layout) == (1, lo.num_rows, lo.layout)
    start = state_from_numpy(R.start_state(4))
    a, b = sh.place_state(start), lo.place_state(start)
    for batch in R.case_batches("pairs_packed"):
        pb = prep.prep_batch(batch, lo.num_rows)
        spb = prep.prep_batch_sharded(batch, sh.num_rows, 1)
        assert np.array_equal(spb.uids, pb.uids)
        a, ma = sh.train_step_prepped(a, spb)
        b, mb = lo.train_step_prepped(b, pb)
        assert float(ma.logloss_sum) == float(mb.logloss_sum)
    ga, gb = state_to_numpy(sh.gather_state(a)), state_to_numpy(b)
    for leaf in LEAVES:
        np.testing.assert_array_equal(ga[leaf], gb[leaf], err_msg=leaf)


def test_sharded_store_refusals():
    base = R.config_keys("pairs_packed", 1)
    upd = FMUpdater(Config.from_kwargs(base).effective_model_param())
    bad = Config.from_kwargs([(k, "2" if k == "num_shards" else v)
                              for k, v in base])
    with pytest.raises(ValueError, match="num_shards 2"):
        ShardedStore(upd, bad, device="cpu")
    hot = Config.from_kwargs(base + [("hot_rows", "64"), ("kernel", "xla"),
                                     ("layout", "auto")])
    with pytest.raises(ValueError, match="hot_rows"):
        ShardedStore(upd, hot, device="cpu")


def test_sharded_prep_matches_jax():
    """prep_batch_sharded, shard_bucket_fills and the stacked sorted slots
    against the JAX package's, on Zipf ids over 3 groups."""
    from difacto_tpu.data import prep as jprep

    b = R.case_batches("pairs_zipf_tail")[0]
    got = prep.prep_batch_sharded(b, 6144, 3)
    ref = jprep.prep_batch_sharded(b, 6144, 3)
    for f in ("uids", "ucounts", "inv", "valid", "dropped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    assert (got.ub, got.num_shards) == (ref.ub, ref.num_shards)
    np.testing.assert_array_equal(prep.shard_bucket_fills(got, 6144),
                                  jprep.shard_bucket_fills(ref, 6144))
    ss = prep.build_sorted_slots_sharded(got, with_slots=True)
    jss = jprep.build_sorted_slots_sharded(ref, with_slots=True)
    for f in ("x_sorted", "bidx", "inv_sorted", "slot_sorted"):
        np.testing.assert_array_equal(getattr(ss, f), getattr(jss, f), f)
    small = prep.prep_batch_sharded(b, 6144, 3, fixed_ub=16)
    assert float(small.dropped.sum()) > 0
    with pytest.raises(ValueError, match="divide"):
        prep.prep_batch_sharded(b, 6144, 5)


# -- K1: the apply over S sorted segments ------------------------------------


@pytest.mark.parametrize("layout", ["planar", "packed"])
@pytest.mark.parametrize("S,K,wupd,vupd,tff", [(2, 4, "ftrl", "adagrad", 0),
                                               (3, 0, "ftrl", "adagrad", 0),
                                               (4, 3, "sgd", "adagrad", 2),
                                               (3, 2, "adagrad", "sgd", 0)])
def test_k1_plain_matches_jax(layout, S, K, wupd, vupd, tff):
    """K1's plain version (the wrapper on CPU tensors: a stable sort, then
    the one-stream plain apply) against the JAX apply_pairs in interpret
    mode walking a ``build_pair_meta(..., seg_len=C)`` schedule, on S
    segments that repeat ids within and across segments; B2's tolerance
    (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(400 + 10 * S + K)
    tp = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    jp = JFMParam()
    for f in ("V_dim", "w_updater", "V_updater", "tail_feature_filter",
              "V_threshold", "l1", "lr_eta"):
        setattr(jp, f, getattr(tp, f))
    s = state_np(K, rng)
    uids, valid = seg_stream(rng, S)
    pay = seg_payload(K, valid, rng)
    C = uids.shape[0] // S
    m = jps.build_pair_meta(uids, N, 512, seg_len=C)
    ref = jps.apply_pairs(
        JFMState(**{k: jnp.asarray(v) for k, v in s.items()}),
        jnp.asarray(uids), jnp.asarray(pay),
        tuple(jnp.asarray(x) for x in (m.blocks, m.wins, m.first, m.wfirst)),
        jp, block_rows=512, interpret=True)
    st = state_from_numpy(s)
    if layout == "packed":
        st = pack_state(st)
    out = pair_sweep.apply_pairs(st, torch.from_numpy(uids),
                                 torch.from_numpy(pay), tp, seg_len=C)
    assert out is st  # in place
    got = state_to_numpy(out)
    for leaf in LEAVES:
        np.testing.assert_allclose(got[leaf], np.asarray(getattr(ref, leaf)),
                                   rtol=1e-5, atol=1e-6, err_msg=leaf)


def test_k1_plain_disjoint_segments_match_one_stream():
    """Disjoint segments: K1's plain version gives the floats of the
    one-stream apply on the merged sorted stream, and refuses a segment
    length that does not divide the stream."""
    rng = np.random.default_rng(420)
    p = port_params(V_dim=4)
    s = state_np(4, rng)
    uids, valid = seg_stream(rng, 3, disjoint=True)
    pay = seg_payload(4, valid, rng)
    order = np.argsort(uids, kind="stable")
    a = pair_sweep.apply_pairs(state_from_numpy(s), torch.from_numpy(uids),
                               torch.from_numpy(pay), p, seg_len=256)
    b = pair_sweep.apply_pairs(state_from_numpy(s),
                               torch.from_numpy(uids[order]),
                               torch.from_numpy(pay[:, order].copy()), p)
    for leaf in LEAVES:
        assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf
    with pytest.raises(ValueError, match="does not divide"):
        pair_sweep.apply_pairs(state_from_numpy(s), torch.from_numpy(uids),
                               torch.from_numpy(pay), p, seg_len=100)


# -- store=sharded through the learner and the CLI, S = 1 --------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctr_sharded")
    write_libsvm(make_ctr_data(4000, num_fields=10, vocab_per_field=300,
                               seed=1), str(d / "train.svm"))
    write_libsvm(make_ctr_data(1000, num_fields=10, vocab_per_field=300,
                               seed=2), str(d / "val.svm"))
    return d


def _recipe(d, *extra):
    return [("data_in", str(d / "train.svm")),
            ("data_val", str(d / "val.svm")), ("batch_size", "500"),
            ("num_bits", "14"), ("max_nnz_per_row", "12"), ("V_dim", "8"),
            ("lr_eta", "0.1"), ("l1", "0.1"), ("V_lr_eta", "0.05"),
            ("max_num_epochs", "2"), *extra]


def _start(tmp_path):
    rng = np.random.default_rng(3)
    n = 1 << 14
    s = {k: np.zeros(n, np.float32) for k in ("w", "z", "n", "cnt")}
    s["V"] = rng.uniform(-0.01, 0.01, (8, n)).astype(np.float32)
    s["nV"] = np.zeros((8, n), np.float32)
    path = str(tmp_path / "start")
    jcheckpoint.save(path, JFMState(**s), {"epoch": 0})
    return path


def test_sharded_learner_and_cli_match_jax(data, tmp_path):
    """``store=sharded`` at S = 1 through SGDLearner (prep over one row
    group, the capacity pin at each epoch's end, the gathered checkpoint)
    trains the verify recipe as the JAX learner does (logloss rel 1e-5,
    AUC abs 1e-5) and as the port's ``store=local`` does, to the bits;
    the CLI's ``task=predict`` with ``store=sharded`` scores its
    checkpoint as the JAX package's predict does."""
    start, model = _start(tmp_path), str(tmp_path / "model")
    kw = _recipe(data, ("model_in", start))
    jva = JSGDLearner(JConfig.from_kwargs(kw + [("store", "local")])).run()
    learner = SGDLearner(Config.from_kwargs(
        kw + [("store", "sharded"), ("model_out", model)]), device="cpu")
    assert isinstance(learner.store, ShardedStore) and learner.store.S == 1
    va = learner.run()
    assert va.num_examples == jva.num_examples == 1000
    assert va.logloss == pytest.approx(jva.logloss, rel=1e-5)
    assert va.exact_auc == pytest.approx(jva.exact_auc, abs=1e-5)
    local = SGDLearner(Config.from_kwargs(kw + [("store", "local")]),
                       device="cpu").run()
    assert (local.logloss, local.exact_auc) == (va.logloss, va.exact_auc)
    host, meta = jcheckpoint.load(model)
    assert meta["epoch"] == 2 and host.V.shape == (8, 1 << 14)
    pred = str(tmp_path / "pred.txt")
    assert cli.main([f"{k}={v}" for k, v in _recipe(data)] + [
        "task=predict", f"model_in={model}", f"pred_out={pred}",
        "store=sharded", f"data_in={data / 'val.svm'}"], device="cpu") == 0
    got = np.loadtxt(pred)
    jl = JSGDLearner(JConfig.from_kwargs(
        _recipe(data, ("model_in", model), ("max_num_epochs", "0"),
                ("store", "local"))))
    ref, _ = jl.predict(str(data / "val.svm"))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)
