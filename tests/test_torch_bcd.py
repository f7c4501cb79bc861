"""The port's BCD learner (``learner=bcd``) and its tile store against the
JAX package.

The tile files are compared byte for byte with the JAX package's
``build_tiles`` and loaded by either package. The block step, from one
NumPy state, matches JAX's ``shard_map`` step within rel 1e-5 / abs 1e-6
(sigmoids differ in the last bits, sums in order). w after one epoch
matches JAX's ``BCDLearner`` at ``num_shards=1`` and ``=8`` within rtol
2e-4 / atol 2e-5, the bound tests/test_bcd.py holds between shard counts;
the recipe's logloss within rel 1e-5 and AUC within abs 1e-5 (no l1
threshold needed looser bounds). Validation, checkpoints both ways, the
CLI's train and ``task=predict`` and the refusal of ``V_dim > 0`` too.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu import cli as jcli
from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.batch_iter import BatchIter as JBatchIter
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.data.tile_store import TileStore as JTileStore
from difacto_tpu.data.tile_store import build_tiles as jbuild_tiles
from difacto_tpu.learners.bcd import BCDLearner as JBCDLearner
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data.batch_iter import BatchIter
from difacto_tpu_torch.data.tile_store import TileStore, build_tiles
from difacto_tpu_torch.learners.bcd import BCDLearner, block_step
from difacto_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

TILE_FILES = ("row.i32", "col.i32", "val.f32", "offsets.npy", "extents.npy",
              "labels.npy", "tiles.json")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("bcd")
    for name, rows, seed in (("tr", 4000, 1), ("va", 1000, 9)):
        write_libsvm(make_ctr_data(rows, num_fields=10, vocab_per_field=200,
                                   seed=seed, w_scale=0.5, v_scale=0.05),
                     str(d / f"{name}.svm"))
    return d


def _kw(data, **kw):
    base = dict(data_in=str(data / "tr.svm"), batch_size="1024",
                num_bits="13", max_nnz_per_row="12", V_dim="0",
                max_num_epochs="3", l1="0.05", l2="0.1", learner="bcd")
    base.update({k: str(v) for k, v in kw.items()})
    return list(base.items())


def _both(data, **kw):
    """The JAX learner and the port's (on the CPU) on one config."""
    return (JBCDLearner(JConfig.from_kwargs(_kw(data, **kw))),
            BCDLearner(Config.from_kwargs(_kw(data, **kw)), device="cpu"))


def _iter(cls, data):
    return lambda: cls(str(data / "tr.svm"), batch_size=1024, max_nnz=12,
                       num_bits=13)


@pytest.mark.parametrize("S", [1, 4])
def test_tile_files_byte_equal_to_jax(data, tmp_path, S):
    a = build_tiles(_iter(BatchIter, data), str(tmp_path / "port"), 1 << 13,
                    num_blocks=16, num_shards=S)
    b = jbuild_tiles(_iter(JBatchIter, data), str(tmp_path / "jax"), 1 << 13,
                     num_blocks=16, num_shards=S)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", TILE_FILES, shallow=False)
    assert sorted(match) == sorted(TILE_FILES), (mismatch, errors)
    assert (a.n, a.tile_nnz, a.total_nnz) == (b.n, b.tile_nnz, b.total_nnz)
    # the sum of the extents is every triplet of the stream
    nnz = sum(int((bt.ids[:int(bt.mask.sum())] >= 0).sum())
              for bt in _iter(BatchIter, data)())
    assert int(np.load(tmp_path / "port" / "extents.npy").sum()) == nnz


@pytest.mark.parametrize("S", [1, 4])
def test_tile_store_loads_in_either_package(data, tmp_path, S):
    build_tiles(_iter(BatchIter, data), str(tmp_path / "port"), 1 << 13,
                num_blocks=16, num_shards=S)
    jbuild_tiles(_iter(JBatchIter, data), str(tmp_path / "jax"), 1 << 13,
                 num_blocks=16, num_shards=S)
    # each package reads the other's directory
    mine = TileStore(str(tmp_path / "jax"))
    theirs = JTileStore(str(tmp_path / "port"))
    assert mine.rows_per_shard == theirs.rows_per_shard
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    for blk in range(16):
        for x, y in zip(mine.fetch(blk), theirs.fetch(blk)):
            np.testing.assert_array_equal(x, y)
    x = np.arange(mine.n, dtype=np.float32)
    np.testing.assert_array_equal(mine.to_shard_order(x, fill=-1.0),
                                  theirs.to_shard_order(x, fill=-1.0))
    np.testing.assert_array_equal(
        mine.from_shard_order(mine.to_shard_order(x)), x)


def test_tile_rows_never_decrease_within_a_tile(data, tmp_path):
    """Triplets keep stream order within a tile (the sorted segments a
    segment sum could take for the py update)."""
    ts = build_tiles(_iter(BatchIter, data), str(tmp_path / "t"), 1 << 13,
                     num_blocks=16, num_shards=4)
    ext = np.load(tmp_path / "t" / "extents.npy")
    for blk in range(16):
        tr, _, _ = ts.fetch(blk)
        for s in range(4):
            assert (np.diff(tr[s, :ext[blk, s]]) >= 0).all()


@pytest.mark.parametrize("S", [1, 4])
def test_block_step_matches_jax(data, S):
    """One block from one random (py, w) state: py and the block's w
    within rel 1e-5 / abs 1e-6 of the JAX step."""
    jl, pl = _both(data, num_shards=S, l1="0.01")
    pl.reset()
    rng = np.random.default_rng(3)
    py0 = rng.normal(size=pl.py.shape[0]).astype(np.float32)
    w0 = (rng.normal(size=pl.num_rows) * 0.1).astype(np.float32)
    w0[rng.random(pl.num_rows) < 0.5] = 0.0
    R = pl.rows_per_block
    for blk in (0, 5, pl.num_blocks - 1):
        tr, tc, tv = jl.tiles.fetch(blk)
        jpy, jw = jl._block_step(
            jnp.asarray(py0), jnp.asarray(pl.yy.numpy()),
            jnp.asarray(pl.mr.numpy()), jnp.asarray(w0[blk * R:(blk + 1) * R]),
            jnp.asarray(tr), jnp.asarray(tc), jnp.asarray(tv))
        pl.py.copy_(torch.from_numpy(py0))
        pl.w.copy_(torch.from_numpy(w0))
        pl.step(blk, *pl.block_tensors(blk))
        np.testing.assert_allclose(pl.py.numpy(), np.asarray(jpy), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pl.w.numpy()[blk * R:(blk + 1) * R],
                                   np.asarray(jw), rtol=1e-5, atol=1e-6)
        # the other blocks' coordinates are untouched
        rest = np.ones(pl.num_rows, bool)
        rest[blk * R:(blk + 1) * R] = False
        np.testing.assert_array_equal(pl.w.numpy()[rest], w0[rest])


def test_padding_slots_add_nothing():
    """Padding triplets (row 0, column 0, value 0) change neither py nor
    w, and do not mark column 0 as touched."""
    py = torch.tensor([0.3, -0.2, 0.1, 0.0])
    yy = torch.tensor([1.0, -1.0, 1.0, -1.0])
    mr = torch.tensor([1.0, 1.0, 1.0, 0.0])
    w = torch.tensor([0.7, 0.0, 0.25])
    rows = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
    cols = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 0.0, 0.0])
    py2, w2 = py.clone(), w.clone()
    block_step(py, yy, mr, w, rows[:2], cols[:2], vals[:2], 0.01, 0.1)
    block_step(py2, yy, mr, w2, rows, cols, vals, 0.01, 0.1)
    assert torch.equal(py2, py) and torch.equal(w2, w)
    assert w[1] != 0.0  # the real column moved
    assert w2[0] == 0.7 and w2[2] == 0.25


@pytest.mark.parametrize("S", [1, 8])
def test_w_after_one_epoch_matches_jax(data, S):
    jl, pl = _both(data, num_shards=S, max_num_epochs=1)
    assert jl.S == pl.S == S
    jl.run()
    pl.run()
    np.testing.assert_allclose(pl.w.numpy(), np.asarray(jl.w), rtol=2e-4,
                               atol=2e-5)
    assert (pl.w.numpy() != 0).sum() > 0


@pytest.mark.parametrize("l1", ["0.05", "2.0"])
def test_recipe_matches_jax(data, l1):
    """Three epochs; logloss, AUC, accuracy and the sparsity by epoch."""
    jl, pl = _both(data, l1=l1)
    got, ref = [], []
    jl.epoch_callbacks.append(lambda e, p: ref.append(p))
    pl.epoch_callbacks.append(lambda e, p: got.append(p))
    jl.run()
    pl.run()
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.logloss, r.logloss, rtol=1e-5)
        assert abs(g.exact_auc - r.exact_auc) <= 1e-5
        assert abs(g.accuracy - r.accuracy) <= 1e-3
        assert abs(g.nnz_w - r.nnz_w) <= max(1, 1e-3 * r.nnz_w)
    assert got[-1].logloss < got[0].logloss


def test_block_order_is_the_jax_packages(data):
    """A NumPy generator seeded with data.seed gives both packages one
    block order."""
    _, pl = _both(data, seed=7)
    pl.reset()
    ref = np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(pl._rng.permutation(pl.num_blocks),
                                      ref.permutation(pl.num_blocks))


def test_validation_matches_jax(data):
    jl, pl = _both(data, data_val=str(data / "va.svm"), max_num_epochs=2)
    jp, pp = jl.run(), pl.run()
    assert pp.num_examples == jp.num_examples == 1000
    np.testing.assert_allclose(pp.logloss, jp.logloss, rtol=1e-5)
    assert abs(pp.exact_auc - jp.exact_auc) <= 1e-5
    assert abs(pp.auc - jp.auc) <= 1e-5
    np.testing.assert_allclose(pp.pred_sum, jp.pred_sum, rtol=1e-5)
    assert pp.exact_auc > 0.65 and pp.nnz_w == jp.nnz_w > 0


def test_checkpoint_loads_in_either_package(data, tmp_path):
    jl, pl = _both(data, max_num_epochs=1)
    jl.cfg.learner.model_out = str(tmp_path / "jax")
    pl.cfg.learner.model_out = str(tmp_path / "port")
    jl.run()
    pl.run()
    for prefix, w in ((tmp_path / "jax", np.asarray(jl.w)),
                      (tmp_path / "port", pl.w.numpy())):
        mine, meta = checkpoint.load(str(prefix))
        theirs, jmeta = jcheckpoint.load(str(prefix))
        assert meta["learner"] == jmeta["learner"] == "bcd"
        np.testing.assert_array_equal(mine.w.numpy(), w)
        for k in ("w", "z", "n", "V", "nV", "cnt"):
            np.testing.assert_array_equal(getattr(mine, k).numpy(),
                                          np.asarray(getattr(theirs, k)))
        assert mine.V.shape == (0, 1 << 13)
        assert not mine.z.any() and not mine.cnt.any()


def test_cli_train_and_predict_match_jax(data, tmp_path):
    """``learner=bcd`` through the CLI of either package, then
    ``task=predict`` (the SGD eval path, B1 at K = 0 on the card) on each
    checkpoint in both: the same scores (6 digits in pred_out)."""
    argv = [f"data_in={data / 'tr.svm'}", "batch_size=1024", "num_bits=13",
            "max_nnz_per_row=12", "V_dim=0", "learner=bcd", "l1=0.05",
            "max_num_epochs=2"]
    assert cli.main([*argv, f"model_out={tmp_path / 'p'}"],
                    device="cpu") == 0
    assert jcli.main([*argv, f"model_out={tmp_path / 'j'}"]) == 0
    scores = {}
    for model in ("p", "j"):
        pred = [f"data_in={data / 'va.svm'}", "task=predict", "learner=bcd",
                "batch_size=1024", "num_bits=13", "max_nnz_per_row=12",
                "V_dim=0", f"model_in={tmp_path / model}"]
        out = tmp_path / f"{model}_port.txt"
        assert cli.main([*pred, f"pred_out={out}"], device="cpu") == 0
        jout = tmp_path / f"{model}_jax.txt"
        assert jcli.main([*pred, f"pred_out={jout}", "store=local"]) == 0
        scores[model] = np.loadtxt(out)
        assert scores[model].shape == (1000,)
        np.testing.assert_allclose(scores[model], np.loadtxt(jout),
                                   rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(scores["p"], scores["j"], rtol=2e-4, atol=5e-5)


def test_bcd_tile_dir_is_kept(data, tmp_path):
    cfg = Config.from_kwargs(_kw(data, bcd_tile_dir=str(tmp_path / "tiles"),
                                 max_num_epochs=1))
    BCDLearner(cfg, device="cpu").run()
    assert sorted(os.listdir(tmp_path / "tiles")) == sorted(TILE_FILES)


def test_bcd_refuses_factors(data):
    cfg = Config.from_kwargs(_kw(data, V_dim=8))
    with pytest.raises(ValueError, match="V_dim=0"):
        BCDLearner(cfg, device="cpu")
    with pytest.raises(AssertionError):
        JBCDLearner(JConfig.from_kwargs(_kw(data, V_dim=8)))


def test_bcd_refuses_hot_rows(data):
    """The JAX package's cross-check, kept: hot_rows is an SGD feature."""
    with pytest.raises(ValueError, match="hot_rows"):
        Config.from_kwargs(_kw(data, hot_rows=64))
    with pytest.raises(ValueError, match="hot_rows"):
        JConfig.from_kwargs(_kw(data, hot_rows=64))


def test_bcd_needs_a_card_unless_asked_for_cpu(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        BCDLearner(Config.from_kwargs(_kw(data)))
