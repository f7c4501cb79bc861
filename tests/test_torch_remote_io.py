"""The port's remote IO (fsspec URIs, data/io.py) against local files and
the JAX package.

As tests/test_remote_io.py, on fsspec's in-process ``memory://``
filesystem (no network; per process, so every run here is in process):
glob and directory expansion, libsvm byte-range parts, gzip streams, csr
parts and checkpoints give the same batches and arrays as the local files
and as the JAX package, exactly. Also the converter's remote input, the
BCD tile build from remote parts (byte-equal to the local build) and the
CLI's train and ``task=predict`` with every URI remote, whose scores equal
the local run's bit for bit. The sharded checkpoint's topology change
waits for the sharded store (ROADMAP A9).
"""

import filecmp
import gzip

import numpy as np
import pytest
import torch

from difacto_tpu.data.batch_iter import BatchIter as JBatchIter
from difacto_tpu.data.converter import load_csr_shard as jload_csr_shard
from difacto_tpu.data.synthetic import make_ctr_data, write_libsvm
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.data import converter, io
from difacto_tpu_torch.data.batch_iter import BatchIter, expand_uri
from difacto_tpu_torch.data.tile_store import build_tiles
from difacto_tpu_torch.utils import checkpoint
from difacto_tpu_torch.utils.checkpoint import state_from_numpy

fsspec = pytest.importorskip("fsspec")

torch.set_num_threads(2)

LEAVES = ("w", "z", "n", "V", "nV", "cnt")


def _put(path: str, data: bytes) -> None:
    with fsspec.filesystem("memory").open(path, "wb") as f:
        f.write(data)


@pytest.fixture
def corpus(tmp_path):
    blk = make_ctr_data(600, num_fields=8, vocab_per_field=200, seed=5)
    local = tmp_path / "train.svm"
    write_libsvm(blk, str(local))
    data = local.read_bytes()
    _put("/tbucket/train.svm", data)
    _put("/tbucket/train.svm.gz", gzip.compress(data))
    yield blk, str(local), data
    fsspec.filesystem("memory").rm("/tbucket", recursive=True)


def _collect(it):
    return [(b.ids.copy(), b.vals.copy(), b.labels.copy(), b.mask.copy())
            for b in it]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_expand_uri_remote_glob_and_dir(corpus):
    hits = expand_uri("memory://tbucket/*.svm")
    assert hits == ["memory:///tbucket/train.svm"]  # fs-canonical path
    assert "memory:///tbucket/train.svm" in expand_uri("memory://tbucket")
    with io.open_uri(hits[0]) as f:
        assert f.read(1)
    assert io.uri_size(hits[0]) == len(corpus[2])
    with pytest.raises(FileNotFoundError):
        expand_uri("memory://tbucket/*.nope")


def test_remote_libsvm_matches_local_and_jax(corpus):
    _, local, _ = corpus
    a = _collect(BatchIter(local, 128, 10, 14))
    _assert_same_batches(a, _collect(
        BatchIter("memory://tbucket/train.svm", 128, 10, 14)))
    _assert_same_batches(a, _collect(
        JBatchIter("memory://tbucket/train.svm", 128, 10, 14)))


@pytest.mark.parametrize("num_parts", [2, 3])
def test_remote_byte_range_parts_cover_exactly(corpus, num_parts):
    """Each part's batches equal the local part's and the JAX package's;
    together they hold every row once."""
    _, local, _ = corpus
    rows = 0
    for p in range(num_parts):
        kw = dict(part_index=p, num_parts=num_parts)
        got = _collect(BatchIter("memory://tbucket/train.svm", 128, 10, 14,
                                 **kw))
        _assert_same_batches(got, _collect(BatchIter(local, 128, 10, 14,
                                                     **kw)))
        _assert_same_batches(got, _collect(JBatchIter(
            "memory://tbucket/train.svm", 128, 10, 14, **kw)))
        rows += sum(int(m.sum()) for *_x, m in got)
    assert rows == 600


def test_remote_gzip_stream(corpus):
    _, local, _ = corpus
    a = _collect(BatchIter(local, 128, 10, 14))
    b = _collect(BatchIter("memory://tbucket/train.svm.gz", 128, 10, 14))
    _assert_same_batches(a, b)
    _assert_same_batches(b, _collect(
        JBatchIter("memory://tbucket/train.svm.gz", 128, 10, 14)))


def test_remote_csr_shard_and_converter(corpus, tmp_path):
    blk, _, _ = corpus
    path = tmp_path / "shard.npz"
    np.savez(path, labels=blk.labels, indptr=blk.indptr,
             indices=blk.indices, values=blk.values)
    _put("/tbucket/shard.npz", path.read_bytes())
    a = converter.load_csr_shard(str(path))
    for b in (converter.load_csr_shard("memory://tbucket/shard.npz"),
              jload_csr_shard("memory://tbucket/shard.npz")):
        for k in ("labels", "indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    c = converter.load_csr_shard("memory://tbucket/shard.npz", part_index=1,
                                 num_parts=2)
    np.testing.assert_array_equal(c.labels, a.labels[len(a.labels) // 2:])
    # the converter reads remote text: the same parts as from the local file
    remote = converter.convert_file("memory://tbucket/train.svm",
                                    str(tmp_path / "r"), rows_per_shard=256)
    local = converter.convert_file(corpus[1], str(tmp_path / "l"),
                                   rows_per_shard=256)
    assert len(remote) == len(local) == 3
    for x, y in zip(remote, local):
        with np.load(x) as zx, np.load(y) as zy:
            assert sorted(zx.files) == sorted(zy.files)
            for k in zx.files:
                np.testing.assert_array_equal(zx[k], zy[k])


def _state_np(rng, n=64, k=4):
    return {"w": rng.normal(size=n).astype(np.float32),
            "z": rng.normal(size=n).astype(np.float32),
            "n": rng.random(n).astype(np.float32),
            "V": rng.normal(size=(k, n)).astype(np.float32),
            "nV": rng.random((k, n)).astype(np.float32),
            "cnt": rng.integers(0, 5, n).astype(np.float32)}


def test_remote_checkpoint_roundtrip():
    """model_out/model_in on an object store: the port's save and load
    round-trip exactly, and the JAX package reads the same files."""
    st = _state_np(np.random.default_rng(4))
    prefix = "memory://tbucket/ckpt/model"
    out = checkpoint.save(prefix, state_from_numpy(st), {"epoch": 2})
    assert out == prefix + ".npz"
    loaded, meta = checkpoint.load(prefix)
    jloaded, jmeta = jcheckpoint.load(prefix)
    assert meta["epoch"] == jmeta["epoch"] == 2
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(loaded, k).numpy(), st[k])
        np.testing.assert_array_equal(np.asarray(getattr(jloaded, k)), st[k])
    fsspec.filesystem("memory").rm("/tbucket", recursive=True)


def test_remote_checkpoint_written_by_jax_loads_in_the_port():
    import jax

    from difacto_tpu.updaters.updater import FMState as JFMState

    st = _state_np(np.random.default_rng(5))
    prefix = "memory://tbucket/jckpt/model"
    jcheckpoint.save(prefix, jax.device_put(JFMState(**st)), {"epoch": 3})
    loaded, meta = checkpoint.load(prefix)
    assert meta["epoch"] == 3 and meta["format_version"] == 1
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(loaded, k).numpy(), st[k])
    # no meta sidecar: an empty dict, as locally
    fsspec.filesystem("memory").rm(prefix + ".meta.json")
    assert checkpoint.load(prefix)[1] == {}
    fsspec.filesystem("memory").rm("/tbucket", recursive=True)


def test_file_uri_checkpoint_roundtrip(tmp_path, monkeypatch):
    """A file:// prefix is a local path: save writes under it (not under
    a relative ./file: directory), and both spellings load it, in the
    port and in the JAX package."""
    monkeypatch.chdir(tmp_path)
    st = _state_np(np.random.default_rng(9))
    prefix = tmp_path / "sub" / "model"
    out = checkpoint.save(f"file://{prefix}", state_from_numpy(st),
                          {"epoch": 1})
    assert out == f"file://{prefix}.npz"
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == [
        "model.meta.json", "model.npz"]
    assert not (tmp_path / "file:").exists()
    for loaded, meta in (checkpoint.load(f"file://{prefix}"),
                         checkpoint.load(str(prefix)),
                         jcheckpoint.load(str(prefix))):
        assert meta["epoch"] == 1
        for k in LEAVES:
            np.testing.assert_array_equal(np.asarray(getattr(loaded, k)),
                                          st[k])


def test_cli_file_uri_model_and_predictions(tmp_path, monkeypatch):
    """model_out, model_in and pred_out as file:// URIs: the same
    checkpoint and scores as plain local paths, bit for bit."""
    monkeypatch.chdir(tmp_path)
    write_libsvm(make_ctr_data(600, num_fields=6, vocab_per_field=100,
                               seed=10), str(tmp_path / "tr.svm"))
    shape = [f"data_in={tmp_path / 'tr.svm'}", "batch_size=128",
             "num_bits=10", "max_nnz_per_row=6", "V_dim=2", "lr_eta=0.1"]
    got = {}
    for where, root in (("plain", str(tmp_path / "plain")),
                        ("file", f"file://{tmp_path / 'file'}")):
        assert cli.main([*shape, "max_num_epochs=1",
                         f"model_out={root}/m"], device="cpu") == 0
        assert cli.main([*shape, "task=predict", f"model_in={root}/m",
                         f"pred_out={root}/pred.txt"], device="cpu") == 0
        got[where] = ((tmp_path / where / "pred.txt").read_bytes(),
                      checkpoint.load(f"{root}/m")[0])
    assert not (tmp_path / "file:").exists()
    assert got["plain"][0] == got["file"][0]
    assert len(got["plain"][0].splitlines()) == 600
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(got["plain"][1], k).numpy(),
                                      getattr(got["file"][1], k).numpy())


def test_remote_tile_build_byte_equal_to_local(tmp_path):
    """BCD's tiles built from csr parts on memory:// equal the local
    build's files."""
    blk = make_ctr_data(500, num_fields=8, vocab_per_field=100, seed=6)
    local = tmp_path / "p.part00000.npz"
    np.savez(local, labels=blk.labels, indptr=blk.indptr,
             indices=blk.indices, values=blk.values)
    _put("/tbucket/parts/p.part00000.npz", local.read_bytes())
    for name, uri in (("local", str(local)),
                      ("remote", "memory://tbucket/parts/p.part*.npz")):
        build_tiles(lambda uri=uri: BatchIter(uri, 128, 8, 12,
                                              data_format="csr"),
                    str(tmp_path / name), 1 << 12, num_blocks=8,
                    num_shards=2)
    files = ("row.i32", "col.i32", "val.f32", "offsets.npy", "extents.npy",
             "labels.npy", "tiles.json")
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "local", tmp_path / "remote", files, shallow=False)
    assert not mismatch and not errors
    fsspec.filesystem("memory").rm("/tbucket", recursive=True)


@pytest.mark.parametrize("learner", ["sgd", "bcd"])
def test_cli_with_every_uri_remote(tmp_path, learner):
    """Train (data_in in two byte-range parts, data_val gzip, model_out)
    and task=predict (model_in, pred_out) with every URI on memory://:
    the same checkpoint and scores as the local run, bit for bit."""
    tr = make_ctr_data(1500, num_fields=8, vocab_per_field=150, seed=7)
    va = make_ctr_data(400, num_fields=8, vocab_per_field=150, seed=8)
    write_libsvm(tr, str(tmp_path / "tr.svm"))
    write_libsvm(va, str(tmp_path / "va.svm"))
    (tmp_path / "va.svm.gz").write_bytes(
        gzip.compress((tmp_path / "va.svm").read_bytes()))
    _put("/tbucket/cli/tr.svm", (tmp_path / "tr.svm").read_bytes())
    _put("/tbucket/cli/va.svm.gz", (tmp_path / "va.svm.gz").read_bytes())
    shape = ["batch_size=256", "num_bits=12", "max_nnz_per_row=8",
             "num_parts_per_file=2", f"learner={learner}"]
    shape += ["V_dim=0"] if learner == "bcd" else ["V_dim=4", "lr_eta=0.1"]
    roots = {"local": (str(tmp_path / "tr.svm"), str(tmp_path / "va.svm.gz"),
                       str(tmp_path / "m"), str(tmp_path / "pred.txt")),
             "remote": ("memory://tbucket/cli/tr.svm",
                        "memory://tbucket/cli/va.svm.gz",
                        "memory://tbucket/cli/m",
                        "memory://tbucket/cli/pred.txt")}
    got = {}
    for where, (tr_uri, va_uri, model, pred) in roots.items():
        assert cli.main([f"data_in={tr_uri}", f"data_val={va_uri}", *shape,
                         "max_num_epochs=2", f"model_out={model}"],
                        device="cpu") == 0
        assert cli.main([f"data_in={va_uri}", *shape, "task=predict",
                         f"model_in={model}", f"pred_out={pred}"],
                        device="cpu") == 0
        with io.open_uri(pred) as f:
            got[where] = (f.read(), checkpoint.load(model)[0])
    assert got["local"][0] == got["remote"][0]
    assert len(got["local"][0].splitlines()) == 400
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(got["local"][1], k).numpy(),
                                      getattr(got["remote"][1], k).numpy())
    fsspec.filesystem("memory").rm("/tbucket", recursive=True)
