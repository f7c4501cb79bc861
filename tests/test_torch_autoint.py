"""The port's AutoInt (``loss=autoint``) against the plain reference
(tests/autoint_reference.py, float64 and autograd) on the CPU, at 64 rows
of 39 fields and the published widths (d = 16, three layers, two heads of
d' = 32, the residual on), from seeded weights.

The tolerances are float32's: the port computes in float32 and the
reference in float64, so each gap is a few units of float32 rounding
(2^-24 ~ 6e-8) grown by the depth of the sums (three layers of 64-wide
products, 39-wide softmaxes, the output's 2,496-wide sum, gradients summed
over 64 rows). Each is set an order of magnitude above the largest gap
measured over the seeds and an order below what the same program gives
with its matrix products in TF32 (a 10-bit mantissa; the card's default
for float32 products where TF32 is allowed) or bfloat16, which
:func:`test_lower_precision_matmuls_fail_the_tolerances` shows.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import autoint_reference as ref

from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import Batch, BatchIter
from difacto_tpu_torch.data.synthetic import make_ctr_data, write_libffm
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.models import autoint
from difacto_tpu_torch.parallel.store import LocalStore, make_store
from difacto_tpu_torch.data.prep import prep_batch
from difacto_tpu_torch.updaters.updater import FMUpdater
from difacto_tpu_torch.utils import checkpoint, tracing
from difacto_tpu_torch.utils.checkpoint import state_to_numpy

torch.set_num_threads(2)

F, D, B, BITS = 39, 16, 64, 12
N = 1 << BITS
WIDTHS = ref.Widths(F=F, d=D)
DIMS = autoint.Dims(F=F, d=D, layers=3, heads=2, head_dim=32)

# margins: relative to the largest |py|; the summed loss: relative; the
# per-slot dV and each dense weight's gradient: relative to its largest
# entry. Measured over seeds 0-5 (f32) and 0-2 (TF32 / bfloat16 operands):
# py 5.3e-7 (4.9e-4 / 4.7e-3), loss 1.2e-8 (3.6e-6 / 9.1e-6), dV 3.4e-7
# (0.13 / 0.21), dense 1.9e-6 (0.041 / 0.075)
TOL = {"py": 5e-6, "loss": 1e-7, "dV": 1e-5, "dense": 1e-5}
# a step's summed logloss as the learner's metrics hold it: a float32 sum
# over the batch's rows
METRIC_TOL = 1e-6
# a train step from the same state: the table's leaves and Adam's moments,
# relative to each leaf's largest entry (float32 sums of 64 rows' slot
# gradients; measured ≤ 3e-7). The dense weights are held to Adam applied
# to the port's own moments, to float32's rounding of a weight: Adam's
# early steps, ~lr sign(g) a weight, turn a gradient near its eps/sqrt(1 -
# b2) ~ 3e-7 into a step of any size, so two states a few float32 units
# apart part ways within a step or two, and each step is checked from the
# port's state
STEP_TOL = {"leaf": 2e-5, "theta": 2e-8}


def _cfg(*extra):
    return Config.from_kwargs([
        ("loss", "autoint"), ("data_format", "libffm"),
        ("num_fields", str(F)), ("max_nnz_per_row", str(F)),
        ("V_dim", str(D)), ("num_bits", str(BITS)),
        ("batch_size", str(B)), ("V_threshold", "2"), *extra])


def _rows(seed, pad=True):
    """A batch of B rows: each its 39 fields in a shuffled slot order, ids
    from a small vocabulary (rows repeat across batches), values in
    [0.5, 1.5], a few slots padded (PAD_ID, value 0, field 0)."""
    rng = np.random.default_rng(seed)
    fields = np.stack([rng.permutation(F) for _ in range(B)]).astype(np.int32)
    ids = (fields * 7 + rng.integers(0, 7, (B, F))).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
    if pad:
        drop = rng.random((B, F)) < 0.05
        ids[drop], vals[drop], fields[drop] = -1, 0.0, 0
    labels = (rng.random(B) > 0.5).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0
    return Batch(ids, vals, labels, mask, fields)


def _loss_inputs(seed, dims=DIMS):
    b = _rows(seed)
    rng = np.random.default_rng(seed + 100)
    V = torch.tensor(rng.uniform(-0.5, 0.5, (B, F, D)).astype(np.float32))
    dense = autoint.init_dense(dims, seed, "cpu")
    return b, V, dense


def _gaps(b, V, dense, widths=WIDTHS):
    """The port's loss against the reference: each number's gap over its
    scale."""
    vals, fields = torch.tensor(b.vals), torch.tensor(b.fields)
    labels, mask = torch.tensor(b.labels), torch.tensor(b.mask)
    fwd, g = autoint.autoint_loss_grad(vals, V, labels, mask, fields, dense)
    py, loss, gV, gt = ref.loss_and_grads(
        V.double(), vals.double(), fields, labels.double(), mask.double(),
        dense.theta.double(), widths)

    def rel(a, r):
        return float((a.double() - r).abs().max() / r.abs().max())

    out = {"py": rel(fwd.py, py),
           "loss": abs(float(g.loss.double().sum()) - float(loss))
           / abs(float(loss)),
           "dV": rel(g.dV, gV)}
    got, want = dense.dims.views(dense.grad), widths.weights(gt)
    out["dense"] = max(rel(got[k], want[k]) for k in got)
    assert torch.equal(g.dW, torch.zeros_like(g.dW))  # w takes no part
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_matches_reference(seed):
    """Margins, the summed logloss, the per-slot dV and every dense
    weight's gradient (the three layers' W and the output's w and b)."""
    gaps = _gaps(*_loss_inputs(seed))
    for k, tol in TOL.items():
        assert gaps[k] <= tol, (k, gaps)


def test_loss_matches_reference_at_two_layers():
    """``attn_layers=2``: the same equations over one layer fewer."""
    dims = autoint.Dims(F=F, d=D, layers=2, heads=2, head_dim=32)
    widths = ref.Widths(F=F, d=D, layers=2)
    gaps = _gaps(*_loss_inputs(5, dims), widths)
    for k, tol in TOL.items():
        assert gaps[k] <= tol, (k, gaps)


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_lower_precision_matmuls_fail_the_tolerances(monkeypatch, mode):
    """The same program with its matrix products' operands rounded to
    TF32 (10 mantissa bits, as the card's TF32 GEMMs take them) or to
    bfloat16 misses at least one of the tolerances."""
    def rounded(x):
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
            return x
        if mode == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)

    for name in ("mm", "bmm", "baddbmm", "mv"):
        orig = getattr(torch, name)

        def low(*args, _orig=orig, **kw):
            return _orig(*(rounded(a) for a in args), **kw)

        monkeypatch.setattr(torch, name, low)
    gaps = _gaps(*_loss_inputs(0))
    assert any(gaps[k] > tol for k, tol in TOL.items()), gaps


def test_shuffled_slots_give_the_same_margin():
    """The output concatenates the fields in field order: the same rows
    with their slots in another order give the same margins, bit for
    bit, and the same per-slot gradients, permuted."""
    b, V, dense = _loss_inputs(3)
    perm = torch.stack([torch.randperm(F, generator=torch.Generator()
                                       .manual_seed(i)) for i in range(B)])

    def run(vals, V, fields):
        return autoint.autoint_loss_grad(
            vals, V, torch.tensor(b.labels), torch.tensor(b.mask), fields,
            dense)

    vals, fields = torch.tensor(b.vals), torch.tensor(b.fields)
    f1, g1 = run(vals, V, fields)
    grad1 = dense.grad.clone()
    f2, g2 = run(vals.gather(1, perm), V.gather(1, perm[..., None].expand(
        B, F, D)), fields.gather(1, perm))
    assert torch.equal(f1.py, f2.py)
    assert torch.equal(g1.dV.gather(1, perm[..., None].expand(B, F, D)),
                       g2.dV)
    assert torch.equal(grad1, dense.grad)


def _start(store, seed=5):
    """A start state: V uniform in +-0.4, counts in {0..3} so that the
    gate (V_threshold 2) holds some rows back, the rest zero; Glorot
    dense weights."""
    st = store.init_state(seed)
    rng = np.random.default_rng(seed)
    st.V.copy_(torch.tensor(rng.uniform(-0.4, 0.4, (D, N)).astype(np.float32)))
    st.cnt.copy_(torch.tensor(rng.integers(0, 4, N).astype(np.float32)))
    return st


def _table(st):
    h = state_to_numpy(st)
    return {"w": h["w"], "z": h["z"], "n": h["n"], "cnt": h["cnt"],
            "V": h["V"].T, "nV": h["nV"].T}


def _hyper(cfg):
    m, a = cfg.model, cfg.autoint
    return ref.Hyper(lr_eta=m.lr_eta, lr_beta=m.lr_beta, l1=m.l1, l2=m.l2,
                     V_lr_eta=m.V_lr_eta, V_lr_beta=m.V_lr_beta,
                     V_l2=m.V_l2, V_threshold=m.V_threshold,
                     dense_lr_eta=a.dense_lr_eta, dense_beta1=a.dense_beta1,
                     dense_beta2=a.dense_beta2, dense_eps=a.dense_eps)


def _trainer(st, cfg):
    """The reference, started from a copy of the port's state."""
    d = st.dense
    return ref.Trainer(_table(st), d.theta, WIDTHS, _hyper(cfg), m=d.m,
                       v=d.v, t=d.step)


def _assert_step(table, dense, tr, theta0, cfg, what):
    """The port's state after a step (``table``: its leaves, ``dense``:
    its dense part) against the reference's from the same state
    (``theta0``: the port's weights before it)."""
    for k in ("w", "z", "n", "cnt", "V", "nV"):
        want = getattr(tr, k).numpy()
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(table[k] - want).max() <= STEP_TOL["leaf"] * scale, \
            (what, k)
    a = cfg.autoint
    assert dense.step == tr.t
    for k in ("m", "v"):
        want = getattr(tr, k).numpy()
        gap = np.abs(getattr(dense, k).double().numpy() - want).max()
        assert gap <= STEP_TOL["leaf"] * np.abs(want).max(), (what, k)
    t = dense.step
    lr_t = a.dense_lr_eta * np.sqrt(1 - a.dense_beta2 ** t) / (
        1 - a.dense_beta1 ** t)
    m, v = dense.m.double(), dense.v.double()
    want = theta0 - lr_t * m / (v.sqrt() + a.dense_eps)
    assert float((dense.theta.double() - want).abs().max()) <= \
        STEP_TOL["theta"], what


@pytest.mark.parametrize("extra", [
    (),                                   # the sorted backward, B3
    (("segsum", "scatter"),),             # index_add_
    (("cache_compact", "1"),),            # the stream derived per step
], ids=["sorted", "scatter", "compact"])
def test_store_steps_match_reference(extra):
    """Three train steps of LocalStore (the packed pairs path, the
    kernels' plain versions) against the reference's: the table's leaves,
    the dense weights and Adam's moments and step after each, the summed
    logloss of each; then an eval batch's margins."""
    cfg = _cfg(*extra)
    store = LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                       device="cpu")
    assert (store.kernel, store.layout) == ("pairs", "packed")
    st = _start(store)
    for s in range(3):
        b = _rows(10 + s)
        tr, theta0 = _trainer(st, cfg), st.dense.theta.double().clone()
        st2, m = store.train_step_prepped(st, prep_batch(b, N,
                                                         num_fields=F))
        assert st2 is st and isinstance(st, autoint.AutoIntState)
        _, loss = tr.step(b.ids, b.vals, b.fields, b.labels, b.mask)
        assert abs(float(m.logloss_sum) - float(loss)) <= \
            METRIC_TOL * abs(float(loss))
        _assert_step(_table(st), st.dense, tr, theta0, cfg, f"step {s}")
    tr = _trainer(st, cfg)
    b = _rows(20)
    _, py = store.eval_step_prepped(st, prep_batch(b, N, num_fields=F))
    gate = (tr.cnt >= tr.h.V_threshold).double()
    Vs = (tr.V * gate[:, None])[torch.tensor(b.ids).long().clamp(min=0)]
    want = ref.margins(ref.field_embeddings(
        Vs, torch.tensor(b.vals).double(), torch.tensor(b.fields), F),
        tr.theta, WIDTHS)
    assert float((py.double() - want).abs().max()) <= \
        TOL["py"] * float(want.abs().max())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("autoint")
    for name, n, seed in (("train", 3 * B, 1), ("val", 100, 2)):
        write_libffm(make_ctr_data(n, num_fields=F, vocab_per_field=30,
                                   seed=seed, with_fields=True,
                                   shuffle_slots=True),
                     str(d / f"{name}.ffm"))
    return d


def _learner_kw(data, *extra):
    return [("data_in", str(data / "train.ffm")), ("shuffle", "0"),
            ("V_threshold", "1"), ("V_init_scale", "0.3"), *extra]


def test_learner_steps_match_reference(data):
    """An epoch of SGDLearner over a libffm file, three batches of 64
    rows: each step against the reference's from the learner's state
    before it, on the same hashed rows (read back with the port's
    parser), and the epoch's logloss."""
    cfg = _cfg(*_learner_kw(data))
    learner = SGDLearner(cfg, device="cpu")
    store, steps = learner.store, []
    step = store.train_step_prepped

    def kept(st, pb):
        tr, theta0 = _trainer(st, cfg), st.dense.theta.double().clone()
        out = step(st, pb)
        d = st.dense
        steps.append((tr, theta0, _table(st), SimpleNamespace(
            theta=d.theta.clone(), m=d.m.clone(), v=d.v.clone(),
            step=d.step)))
        return out

    store.train_step_prepped = kept
    prog = learner.train_epoch(0)
    it = BatchIter(str(data / "train.ffm"), batch_size=B, max_nnz=F,
                   num_bits=BITS, data_format="libffm")
    loss = 0.0
    for s, ((tr, theta0, table, dense), b) in enumerate(zip(steps, it)):
        loss += float(tr.step(b.ids, b.vals, b.fields, b.labels, b.mask)[1])
        _assert_step(table, dense, tr, theta0, cfg, f"step {s}")
    assert len(steps) == 3 and steps[-1][3].step == 3
    assert abs(prog.logloss_sum - loss) <= METRIC_TOL * loss


def test_checkpoint_round_trip_and_predict(data, tmp_path):
    """Train with ``model_out``, then load it: the dense part (weights,
    moments, step) comes back bit for bit, and ``task=predict`` from the
    checkpoint writes the margins the trained learner computes."""
    out = str(tmp_path / "m")
    kw = _learner_kw(data, ("data_val", str(data / "val.ffm")),
                     ("max_num_epochs", "2"), ("model_out", out))
    learner = SGDLearner(_cfg(*kw), device="cpu")
    learner.run()
    meta = json.loads((tmp_path / "m.meta.json").read_text())
    assert meta["dense_step"] == 6
    again = SGDLearner(_cfg(*kw[:-1], ("model_in", out)), device="cpu")
    for k in ("theta", "m", "v"):
        assert torch.equal(getattr(again.state.dense, k),
                           getattr(learner.state.dense, k))
    assert again.state.dense.step == 6
    assert torch.equal(again.state.tbl, learner.state.tbl)
    py, _ = learner.predict(str(data / "val.ffm"))
    pred = str(tmp_path / "pred.txt")
    rc = cli.main([f"{k}={v}" for k, v in _cfg_pairs()] + [
        f"data_in={data / 'val.ffm'}", "V_threshold=1", f"model_in={out}",
        "task=predict", f"pred_out={pred}"], device="cpu")
    assert rc == 0
    np.testing.assert_allclose(np.loadtxt(pred), py, rtol=1e-5, atol=1e-6)


def _cfg_pairs():
    return [("loss", "autoint"), ("data_format", "libffm"),
            ("num_fields", str(F)), ("max_nnz_per_row", str(F)),
            ("V_dim", str(D)), ("num_bits", str(BITS))]


def test_checkpoint_without_dense_part_is_refused(tmp_path):
    cfg = Config.from_kwargs([("num_bits", str(BITS)), ("V_dim", str(D))])
    store = make_store(FMUpdater(cfg.model), cfg, device="cpu")
    checkpoint.save(str(tmp_path / "fm"), store.init_state(0))
    with pytest.raises(ValueError, match="no dense weights"):
        SGDLearner(_cfg(("model_in", str(tmp_path / "fm")),
                        ("data_in", "x")), device="cpu")


def test_spans_open_on_the_step_thread(data):
    """A profiled epoch holds ``difacto.attention`` (inside
    ``difacto.loss``) and ``difacto.dense_apply`` (after ``difacto.apply``)
    in every ``difacto.step``, all on the thread that runs the step; the
    counters add each step's rows and dense weights."""
    from torch.profiler import ProfilerActivity, profile

    learner = SGDLearner(_cfg(*_learner_kw(data)), device="cpu")
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        learner.train_epoch(0)
    c = tracing.delta(before)
    assert c["step.attention_rows"] == 3 * B
    assert c["step.dense_params"] == 3 * DIMS.size
    evs = [e for e in prof.events() if e.name.startswith("difacto.")]
    steps = [e for e in evs if e.name == "difacto.step"]
    assert len(steps) == 3

    def inside(e, s):
        return (e.thread == s.thread and s.time_range.start
                <= e.time_range.start and e.time_range.end
                <= s.time_range.end)

    for s in steps:
        names = {e.name: e for e in evs if e is not s and inside(e, s)}
        assert {"difacto.loss", "difacto.attention", "difacto.apply",
                "difacto.dense_apply"} <= set(names)
        assert inside(names["difacto.attention"], names["difacto.loss"])
        assert (names["difacto.apply"].time_range.end
                <= names["difacto.dense_apply"].time_range.start)


def test_dense_size_is_the_papers():
    """Three layers of Q, K, V and Res (16 -> 64, then 64 -> 64) and the
    output over 39 x 64: 39,361 weights."""
    assert DIMS.size == 4 * 16 * 64 + 2 * 4 * 64 * 64 + 39 * 64 + 1 == 39361


def test_config_keys_parse_with_loss_autoint():
    cfg = _cfg(("attn_layers", "2"), ("attn_heads", "4"),
               ("attn_head_dim", "8"), ("attn_residual", "1"),
               ("dense_lr_eta", "0.01"), ("dense_eps", "1e-7"))
    a = cfg.autoint
    assert (a.attn_layers, a.attn_heads, a.attn_head_dim, a.attn_residual,
            a.dense_lr_eta, a.dense_eps) == (2, 4, 8, True, 0.01, 1e-7)
    assert (a.dense_beta1, a.dense_beta2) == (0.9, 0.999)
    assert cfg.expects_fields() and cfg.slot_grads()
    d = autoint.Dims.of(cfg)
    assert d.proj == 4 * 32 and d.size == 16 * 128 + 32 * 128 + 39 * 32 + 1


def test_residual_off_is_refused():
    """The published model has the residual projection; no path runs
    without it."""
    with pytest.raises(ValueError, match="attn_residual=0 is not"):
        _cfg(("attn_residual", "0"))


@pytest.mark.parametrize("loss", ["fm", "ffm"])
def test_autoint_keys_are_refused_with_another_loss(loss):
    with pytest.raises(ValueError, match="keys of loss=autoint"):
        Config.from_kwargs([("loss", loss), ("attn_heads", "2")])
    with pytest.raises(ValueError, match="unknown config keys"):
        Config.from_kwargs([("loss", "autoint"), ("attn_head", "2")])


@pytest.mark.parametrize("key,val", [
    ("store", "sharded"), ("kernel", "xla"), ("kernel", "pallas"),
    ("layout", "planar"), ("layout", "stacked"), ("hot_rows", "1024"),
    ("learner", "bcd"), ("host_localize", "0"),
])
def test_unsupported_path_fails_at_config_time(key, val):
    with pytest.raises(ValueError, match=f"loss=autoint does not support "
                                         f"{key}="):
        _cfg((key, val))


@pytest.mark.parametrize("kw", [
    [("data_format", "libsvm"), ("num_fields", "0")],
    [("num_fields", "0")],
    [("V_dim", "0")],
])
def test_autoint_needs_libffm_fields_and_factors(kw):
    with pytest.raises(ValueError, match="loss=autoint needs"):
        _cfg(*kw)
