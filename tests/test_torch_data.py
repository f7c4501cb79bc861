"""The port's data path against the JAX package's, on the CPU.

Same bytes and the same NumPy inputs through both packages: the libsvm
parse by both of the port's engines (the native parser of
``difacto_tpu_torch/csrc/host/``, built with g++ on first use, and the
NumPy engine), the libffm parse and its errors, the native localizer
against the NumPy one, the csr converter's parts in both directions, the
synthetic libffm data, ``BatchIter`` batches on every format, and the
config's field rules. Every comparison is exact: these are parses,
copies and integer bookkeeping.
"""

import gzip
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from difacto_tpu.config import Config as JConfig
from difacto_tpu.data import converter as jconverter
from difacto_tpu.data import libsvm as jlibsvm
from difacto_tpu.data import prep as jprep
from difacto_tpu.data import synthetic as jsynthetic
from difacto_tpu.data.batch_iter import BatchIter as JBatchIter
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.data import _native, converter, libsvm, prep, synthetic
from difacto_tpu_torch.data.batch_iter import Batch, BatchIter

ROOT = Path(__file__).resolve().parent.parent
BLOCK = ("labels", "indptr", "indices", "values")


def _same_block(got, ref, fields=False):
    for name in BLOCK + (("fields",) if fields else ()):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _random_libsvm(rng, rows=400, eol=b"\n"):
    """libsvm text with float values of up to 7 significant digits, bare
    indices, feature-less rows, comments and blank lines."""
    out = [b"# a comment line", b""]
    for r in range(rows):
        n = int(rng.integers(0, 9))
        toks = [f"{int(rng.integers(0, 2)) * 2 - 1}".encode()]
        for _ in range(n):
            i = int(rng.integers(0, 1 << 40))
            if rng.random() < 0.1:
                toks.append(f"{i}".encode())
            else:
                toks.append(f"{i}:{rng.normal() * 10.0 ** rng.integers(-3, 3):.7g}"
                            .encode())
        out.append(b" ".join(toks))
        if r % 97 == 0:
            out.append(b"   ")
    return eol.join(out) + eol


@pytest.fixture(scope="module")
def native():
    if not _native.available():
        pytest.fail(f"the native host engines did not build: "
                    f"{_native.build_error()}")
    return _native


@pytest.mark.parametrize("text", [
    b"1 0:1.5 7:2\n0 3:1\n# c\n\n-1 2:-1e-2\n",
    b"1 5 9:2.5 11\n",
    b"0 18446744073709551615:1\n",
    b"1\n0 4:2\n1\n",
    b"",
    b"\n# only a comment\n",
    "random", "random_crlf",
], ids=["golden", "bare", "u64", "featureless", "empty", "comment",
        "random", "random_crlf"])
def test_libsvm_engines_match_jax(native, text):
    """The native parser, the port's NumPy engine and the JAX package's
    NumPy engine give the same arrays and dtypes, on comments, blank
    lines, bare indices, uint64 ids, feature-less rows and \\r\\n ends."""
    if text in ("random", "random_crlf"):
        text = _random_libsvm(np.random.default_rng(3),
                              eol=b"\r\n" if text == "random_crlf" else b"\n")
    ref = jlibsvm.parse_libsvm_numpy(text)
    _same_block(libsvm.parse_libsvm_numpy(text), ref)
    _same_block(native.parse_libsvm(text), ref)
    n0 = native.RUNS["parse_native"]
    _same_block(libsvm.parse_libsvm(text), ref)
    assert native.RUNS["parse_native"] == n0 + 1


@pytest.mark.parametrize("nthreads", [1, 2, 3, 8, 13])
def test_native_parse_is_the_same_at_any_thread_count(native, nthreads):
    text = _random_libsvm(np.random.default_rng(4), rows=1000)
    _same_block(native.parse_libsvm(text, nthreads=nthreads),
                libsvm.parse_libsvm_numpy(text))


@pytest.mark.parametrize("text", [b"1 a:1\n", b"x 1:2\n", b"1 3:q\n"])
def test_malformed_libsvm_raises_in_every_engine(native, text):
    for parse in (jlibsvm.parse_libsvm_numpy, libsvm.parse_libsvm_numpy,
                  native.parse_libsvm):
        with pytest.raises(ValueError, match="malformed libsvm input"):
            parse(text)


@pytest.mark.parametrize("text", [
    b"# comment\n1 0:5:1.5 2:7:2 1:3\n0 1:9:0.25\n\n-1 0:2:1 0:4:3\n",
    b"1 3:4:1\r\n0 2:8:0.5 1:1\r\n",
    b"\n# only a comment\n",
    b"",
    b"1\n0 2:3:1\n",
], ids=["golden", "crlf", "comment", "empty", "featureless"])
def test_parse_libffm_matches_jax(text):
    ref = jlibsvm.parse_libffm_numpy(text)
    got = libsvm.parse_libffm(text)
    _same_block(got, ref, fields=True)
    assert got.fields.dtype == np.int32


@pytest.mark.parametrize("text", [b"1 5:1.5 7:2\n", b"1 -1:5:1\n",
                                  b"1 0:5:x\n", b"1 a:5:1\n"],
                         ids=["libsvm", "negative_field", "bad_value",
                              "bad_field"])
def test_malformed_libffm_raises_the_jax_error(text):
    with pytest.raises(ValueError) as ref:
        jlibsvm.parse_libffm_numpy(text)
    with pytest.raises(ValueError) as got:
        libsvm.parse_libffm(text)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("bits,n,pad", [(10, 5000, 0.15), (22, 100_000, 0.15),
                                        (26, 100_000, 0.15), (26, 4096, 0.0),
                                        (26, 1, 1.0), (30, 70_000, 0.3)])
def test_native_localize_matches_numpy(native, bits, n, pad):
    """uids (the sentinel N last when pads exist), inv and counts, with
    their dtypes, equal the NumPy engine's and ``np.unique``'s."""
    rng = np.random.default_rng(bits + n)
    N = 1 << bits
    ids = rng.integers(0, N, n).astype(np.int32)
    ids[rng.random(n) < pad] = -1
    got = native.localize(ids, N)
    ref = prep._localize_numpy(ids, N)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    keys = np.where(ids < 0, np.int32(N), ids)
    u, i, c = np.unique(keys, return_inverse=True, return_counts=True)
    for a, b in zip(got, (u, i, c)):
        np.testing.assert_array_equal(a, b)
    assert (got[0][-1] == N) == bool((ids < 0).any())


@pytest.mark.parametrize("bits,shape", [(26, (512, 16)), (26, (64, 8)),
                                        (22, (512, 16))])
def test_prep_takes_the_native_localizer_past_the_lut_cap(native, bits,
                                                          shape):
    """Past 2^24 rows a batch of at least 4096 slots is localized by the
    native engine, any other by NumPy, and the prepped batch equals the
    JAX package's either way."""
    rng = np.random.default_rng(5)
    N = 1 << bits
    ids = rng.integers(0, N, shape).astype(np.int32)
    ids[rng.random(shape) < 0.1] = -1
    vals = rng.random(shape).astype(np.float32)
    lab = (rng.random(shape[0]) > 0.5).astype(np.float32)
    mask = np.ones(shape[0], np.float32)
    from difacto_tpu.data.batch_iter import Batch as JBatch

    native.reset_runs()
    got = prep.prep_batch(Batch(ids, vals, lab, mask), N)
    ref = jprep.prep_batch(JBatch(ids, vals, lab, mask), N)
    want = int(N > (1 << 24) and ids.size >= 4096)
    assert native.RUNS["localize_native"] == want
    for name in ("uids", "ucounts", "inv", "valid", "vals", "labels",
                 "mask"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _ctr(n, seed, fields=False):
    return jsynthetic.make_ctr_data(n, num_fields=7, vocab_per_field=60,
                                    seed=seed, with_fields=fields,
                                    shuffle_slots=fields)


def test_synthetic_libffm_matches_jax(tmp_path):
    """The port's slot-shuffled libffm generator and writer give the JAX
    package's arrays and bytes; the field is not the slot position."""
    ref = _ctr(300, 2, fields=True)
    got = synthetic.make_ctr_data(300, num_fields=7, vocab_per_field=60,
                                  seed=2, with_fields=True,
                                  shuffle_slots=True)
    _same_block(got, ref, fields=True)
    assert (got.fields.reshape(300, 7) != np.arange(7)).any()
    jsynthetic.write_libffm(ref, str(tmp_path / "j.ffm"))
    synthetic.write_libffm(got, str(tmp_path / "p.ffm"))
    raw = (tmp_path / "p.ffm").read_bytes()
    assert raw == (tmp_path / "j.ffm").read_bytes()
    _same_block(libsvm.parse_libffm(raw), jlibsvm.parse_libffm_numpy(raw),
                fields=True)


@pytest.fixture(scope="module")
def svm(tmp_path_factory):
    d = tmp_path_factory.mktemp("csr")
    path = d / "x.svm"
    path.write_bytes(_random_libsvm(np.random.default_rng(6), rows=1300))
    return path


@pytest.mark.parametrize("rows", [200, 1300, 5000])
def test_converter_parts_match_jax(svm, tmp_path, rows):
    """The same parts, by name and content, from both converters (the
    last part short, or one part), with the npz dtypes u64 ids and f32
    values; small chunks make the parts cross chunk boundaries."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = converter.convert_file(str(svm), str(tmp_path / "p" / "x"), rows,
                                 chunk_bytes=4096)
    ref = jconverter.convert_file(str(svm), str(tmp_path / "j" / "x"), rows,
                                  chunk_bytes=4096)
    assert [Path(p).name for p in got] == [Path(p).name for p in ref]
    assert len(got) == -(-1300 // rows)
    for a, b in zip(got, ref):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files) == sorted(BLOCK)
            for name in BLOCK:
                assert za[name].dtype == zb[name].dtype
                np.testing.assert_array_equal(za[name], zb[name])
        assert np.load(a)["indices"].dtype == np.uint64


@pytest.mark.parametrize("num_parts", [1, 3, 7])
def test_csr_parts_load_across_packages(svm, tmp_path, num_parts):
    """Each package's ``load_csr_shard`` reads the other's parts, and
    splits a part into the same rows."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    mine = converter.convert_file(str(svm), str(tmp_path / "p" / "x"), 500)
    theirs = jconverter.convert_file(str(svm), str(tmp_path / "j" / "x"),
                                     500)
    for path in mine + theirs:
        for part in range(num_parts):
            _same_block(converter.load_csr_shard(path, part, num_parts),
                        jconverter.load_csr_shard(path, part, num_parts))


def test_converter_module_runs(svm, tmp_path):
    """``python -m difacto_tpu_torch.data.converter`` writes the parts."""
    out = tmp_path / "parts"
    r = subprocess.run([sys.executable, "-m",
                        "difacto_tpu_torch.data.converter", str(svm),
                        "--out-dir", str(out), "--rows-per-shard", "600"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "x.svm -> 3 shard(s)" in r.stdout
    assert sorted(p.name for p in out.iterdir()) == [
        f"x.svm.part{i:05d}.npz" for i in range(3)]


def _batches(it):
    return [b for b in it]


@pytest.mark.parametrize("fmt,shuffle,workers,max_nnz", [
    ("libsvm", False, 1, 8), ("libsvm", True, 2, 5), ("libsvm_gz", True, 2, 8),
    ("csr", False, 1, 8), ("csr", True, 2, 5),
    ("libffm", False, 1, 7), ("libffm", True, 2, 7), ("libffm", True, 1, 4),
])
def test_batch_iter_matches_jax(tmp_path, fmt, shuffle, workers, max_nnz):
    """Every batch of two epochs, ids, vals, labels, mask and fields,
    equal to the JAX package's ``BatchIter`` on libsvm text (plain and
    gzip, \\r\\n ends), csr parts and slot-shuffled libffm text, shuffled
    or not, with one or two batchify workers, rows truncated to fewer
    slots than they have or not."""
    rng = np.random.default_rng(8)
    kw = dict(batch_size=96, max_nnz=max_nnz, num_bits=12, shuffle=shuffle,
              seed=4, batch_workers=workers, chunk_bytes=8192)
    if fmt.startswith("libsvm"):
        text = _random_libsvm(rng, rows=700, eol=b"\r\n")
        uri = tmp_path / ("d.svm.gz" if fmt == "libsvm_gz" else "d.svm")
        uri.write_bytes(gzip.compress(text) if fmt == "libsvm_gz" else text)
        fmt = "libsvm"
    elif fmt == "csr":
        src = tmp_path / "d.svm"
        src.write_bytes(_random_libsvm(rng, rows=700))
        converter.convert_file(str(src), str(tmp_path / "d"), 300)
        uri = tmp_path / "d.part*.npz"
    else:
        uri = tmp_path / "d.ffm"
        jsynthetic.write_libffm(_ctr(700, 3, fields=True), str(uri))
    got = BatchIter(str(uri), data_format=fmt, num_parts=2,
                    part_index=range(2), **kw)
    ref = JBatchIter(str(uri), data_format=fmt, num_parts=2,
                     part_index=range(2), **kw)
    for _ in range(2):
        a, b = _batches(got), _batches(ref)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for name in ("ids", "vals", "labels", "mask"):
                np.testing.assert_array_equal(getattr(x, name),
                                              getattr(y, name))
            if fmt == "libffm":
                assert x.fields.shape == x.ids.shape
                np.testing.assert_array_equal(x.fields, y.fields)
            else:
                assert x.fields is None and y.fields is None


_FIELD_RULES = [
    [("num_fields", "4")],
    [("loss", "ffm"), ("num_fields", "4")],
    [("loss", "ffm"), ("data_format", "libffm")],
    [("loss", "ffm"), ("data_format", "libffm"), ("num_fields", "4"),
     ("V_dim", "2"), ("max_nnz_per_row", "8")],
    [("data_format", "libffm")],
    [("data_format", "csr")],
    [("loss", "ffm"), ("data_format", "csr"), ("V_dim", "2"),
     ("max_nnz_per_row", "8")],
]


@pytest.mark.parametrize("kw", _FIELD_RULES,
                         ids=[str(i) for i in range(len(_FIELD_RULES))])
def test_config_field_rules_match_jax(kw):
    """The same ValueError, or the same accepted config: expects_fields
    and the factor width F*k (F = num_fields, or max_nnz_per_row)."""
    try:
        ref = JConfig.from_kwargs(kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Config.from_kwargs(kw)
        assert str(got.value) == str(e)
        return
    cfg = Config.from_kwargs(kw)
    assert cfg.expects_fields() == ref.expects_fields()
    assert (cfg.effective_model_param().V_dim
            == ref.effective_model_param().V_dim)
    assert cfg.data.data_format == ref.data.data_format


@pytest.mark.parametrize("fields,num_fields", [
    (None, 3), (np.full((4, 2), 7, np.int32), 3),
    (np.full((4, 2), 2, np.int32), 3), (None, 0)])
def test_validate_fields_matches_jax(fields, num_fields):
    try:
        jprep.validate_fields(fields, num_fields)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            prep.validate_fields(fields, num_fields)
        assert str(got.value) == str(e)
        return
    prep.validate_fields(fields, num_fields)
