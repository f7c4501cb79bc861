"""The port's model tools (``tools/dump_model.py``, ``tools/table_stats.py``)
against the JAX package's on the same checkpoints.

The dump's text must be byte-equal to JAX's ``dump_model`` and
``table_stats`` must return an equal dict, with and without ``--shards``,
on checkpoints written by either package, local or on ``memory://``.
"""

import io as _io
import json

import jax
import numpy as np
import pytest

from difacto_tpu.tools import dump_model as jdump_model
from difacto_tpu.tools import table_stats as jtable_stats
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch.tools import dump_model, table_stats
from difacto_tpu_torch.utils import checkpoint
from difacto_tpu_torch.utils.checkpoint import state_from_numpy

N = 4096


def _state_np(k: int, seed: int) -> dict:
    """A trained-looking state: a third of w zero, counts with a long tail
    (a few hot rows, many untouched), V nonzero everywhere."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=N).astype(np.float32)
    w[rng.random(N) < 0.33] = 0.0
    cnt = np.floor(rng.pareto(1.2, N) * (rng.random(N) < 0.6)).astype(
        np.float32)
    return {"w": w, "z": rng.normal(size=N).astype(np.float32),
            "n": rng.random(N).astype(np.float32),
            "V": rng.uniform(-0.01, 0.01, (k, N)).astype(np.float32),
            "nV": rng.random((k, N)).astype(np.float32), "cnt": cnt}


@pytest.fixture(params=["port", "jax"])
def ckpt(request, tmp_path):
    """Checkpoints (K = 4, and K = 0 as BCD writes) saved by one package."""
    out = {}
    for k in (4, 0):
        st = _state_np(k, seed=10 + k)
        prefix = str(tmp_path / f"m{k}")
        if request.param == "port":
            checkpoint.save(prefix, state_from_numpy(st), {"epoch": 1})
        else:
            jcheckpoint.save(prefix, jax.device_put(JFMState(**st)),
                             {"epoch": 1})
        out[k] = prefix
    return out


def _dump(mod, prefix, **kw) -> tuple[str, int]:
    buf = _io.StringIO()
    n = mod.dump(prefix, buf, **kw)
    return buf.getvalue(), n


@pytest.mark.parametrize("k", [4, 0])
@pytest.mark.parametrize("kw", [{}, {"limit": 50}, {"include_all": True}],
                         ids=["nonzero", "limit", "all"])
def test_dump_text_byte_equal_to_jax(ckpt, k, kw):
    got, n = _dump(dump_model, ckpt[k], **kw)
    ref, jn = _dump(jdump_model, ckpt[k], **kw)
    assert got == ref and n == jn
    st = _state_np(k, seed=10 + k)
    if not kw:
        # rows with nonzero w or an active factor (touched, V nonzero)
        keep = (st["w"] != 0) | ((st["V"] != 0).any(0) & (st["cnt"] > 0)
                                 if k else False)
        assert n == int(keep.sum()) == len(got.splitlines())


@pytest.mark.parametrize("shards", [0, 4, 3])
def test_table_stats_equal_to_jax(ckpt, shards):
    """3 does not divide the rows: the 'unavailable' string, as in JAX."""
    got = table_stats.stats(ckpt[4], shards=shards)
    assert got == jtable_stats.stats(ckpt[4], shards=shards)
    cnt = _state_np(4, seed=14)["cnt"]
    assert got["occupancy"] == float((cnt > 0).mean())
    assert got["touched"] == int((cnt > 0).sum())


def test_table_stats_of_a_bcd_checkpoint(ckpt):
    """BCD saves no counts: nothing touched, no quantiles."""
    assert table_stats.stats(ckpt[0]) == jtable_stats.stats(ckpt[0])


def test_tools_main(ckpt, tmp_path, capsys):
    out = tmp_path / "dump.txt"
    assert dump_model.main([ckpt[4], "-o", str(out)]) == 0
    jout = tmp_path / "jdump.txt"
    assert jdump_model.main([ckpt[4], "-o", str(jout)]) == 0
    assert out.read_bytes() == jout.read_bytes()
    capsys.readouterr()
    assert table_stats.main([ckpt[4], "--shards", "4"]) == 0
    printed = capsys.readouterr().out
    assert jtable_stats.main([ckpt[4], "--shards", "4"]) == 0
    assert printed == capsys.readouterr().out
    assert json.loads(printed)["rows"] == N


def test_tools_read_a_remote_checkpoint():
    fsspec = pytest.importorskip("fsspec")
    st = _state_np(4, seed=20)
    prefix = "memory://toolbucket/m"
    checkpoint.save(prefix, state_from_numpy(st), {"epoch": 1})
    assert _dump(dump_model, prefix) == _dump(jdump_model, prefix)
    assert table_stats.stats(prefix, 4) == jtable_stats.stats(prefix, 4)
    fsspec.filesystem("memory").rm("/toolbucket", recursive=True)


def test_tools_read_a_per_process_checkpoint(tmp_path, monkeypatch):
    """A multi-process run's file set (three processes, each saving its
    rows through the port's checkpoint.save as it runs under the launch
    contract): the port's tools read it through load_full and print the
    JAX tools' text and dict on it, byte for byte."""
    from difacto_tpu_torch.parallel import multihost

    st = _state_np(4, seed=30)
    prefix = str(tmp_path / "mp")
    cuts = (0, 1366, 2732, N)
    for p in range(3):
        monkeypatch.setattr(multihost, "_JOINED", (p, 3))
        part = {k: v[..., cuts[p]:cuts[p + 1]] for k, v in st.items()}
        checkpoint.save(prefix, state_from_numpy(part), {"epoch": 1},
                        shard=(cuts[p], N))
    monkeypatch.setattr(multihost, "_JOINED", None)
    meta = json.loads((tmp_path / "mp.meta.json").read_text())
    assert meta["sharded"] and meta["process_count"] == 3
    assert _dump(dump_model, prefix) == _dump(jdump_model, prefix)
    assert _dump(dump_model, prefix, include_all=True) == _dump(
        jdump_model, prefix, include_all=True)
    assert table_stats.stats(prefix, 4) == jtable_stats.stats(prefix, 4)
    host, _ = checkpoint.load_full(prefix)
    for k, v in st.items():
        np.testing.assert_array_equal(getattr(host, k).numpy(), v, k)
