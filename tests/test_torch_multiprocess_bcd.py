"""The port's multi-process BCD against the JAX package.

Two and three OS processes run the port's CLI with ``learner=bcd`` on the
CPU under the env contract (``run_processes``, under a timeout), on the
data of tests/test_multiprocess.py with its BCD overrides: each process
tiles its own input part into ``bcd_tile_dir/proc{p}``, the block steps
sum g and h over the processes, and every process applies the same update
to its copy of w. The w of the per-process checkpoint is held against the
JAX package's one-process BCD of the same config (its block update
depends on the global sums alone, invariant to the row partition up to
the order of the additions) at rtol and atol 2e-4
(tests/test_multiprocess.py:396), and every process logs the JAX run's
validation logloss and exact AUC.
"""

import concurrent.futures as cf
import json
import pathlib
import re

import numpy as np
import pytest

from difacto_tpu.config import Config as JConfig
from difacto_tpu.learners.bcd import BCDLearner as JBCDLearner
from difacto_tpu.utils import arg_parser as jarg_parser
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.utils import checkpoint
from test_torch_multiprocess import CLI, launch, write_data

OVERRIDES = ["learner=bcd", "V_dim=0", "l1=0.05", "bcd_num_blocks=64",
             "max_num_epochs=2"]


@pytest.fixture(scope="module")
def bcd(tmp_path_factory):
    """The 2- and 3-process BCD runs, at once, and the JAX package's
    one-process run of the same config (in this process)."""
    tmp = tmp_path_factory.mktemp("mp_bcd")
    write_data(tmp)
    base = [str(tmp / "fm.conf"), *OVERRIDES]
    with cf.ThreadPoolExecutor(2) as pool:
        futs = {P: pool.submit(launch, P, CLI + base + [
            f"bcd_tile_dir={tmp / f'tiles{P}'}",
            f"model_out={tmp / f'bcd{P}'}"]) for P in (2, 3)}
        cfg = JConfig.from_kwargs(jarg_parser.parse(
            base + [f"model_out={tmp / 'jax_bcd'}"]))
        va = JBCDLearner(cfg).run()
        outs = {P: f.result() for P, f in futs.items()}
    return tmp, outs, va


def valid_metrics(out: str) -> tuple[float, float]:
    line = [ln for ln in out.splitlines() if "bcd epoch 1 valid" in ln][-1]
    return (float(re.search(r"logloss (\S+)", line).group(1)),
            float(re.search(r"exact_auc (\S+)", line).group(1)))


@pytest.mark.parametrize("P", [2, 3])
def test_multiprocess_bcd_matches_jax(bcd, P):
    """The per-process checkpoint's w (each process's piece is its whole
    copy; the port's and the JAX package's load_full agree) against the
    JAX one-process w; every process logs the JAX validation metrics."""
    tmp, outs, va = bcd
    prefix = str(tmp / f"bcd{P}")
    meta = json.loads(pathlib.Path(prefix + ".meta.json").read_text())
    assert meta["sharded"] and meta["process_count"] == P
    got, _ = checkpoint.load_full(prefix)
    jgot, _ = jcheckpoint.load_full(prefix)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(jgot.w))
    ref = np.load(tmp / "jax_bcd.npz")["w"]
    np.testing.assert_allclose(got.w.numpy(), ref, rtol=2e-4, atol=2e-4)
    assert np.count_nonzero(ref) > 100
    for out in outs[P]:
        loss, auc = valid_metrics(out)
        assert loss == pytest.approx(va.logloss, rel=2e-4, abs=2e-4)
        assert auc == pytest.approx(va.exact_auc, abs=2e-4)
    # each process tiled its own part
    assert sorted(p.name for p in (tmp / f"tiles{P}").iterdir()) == [
        f"proc{p}" for p in range(P)]
    n = sum(json.loads((tmp / f"tiles{P}" / f"proc{p}" / "tiles.json")
                       .read_text())["n"] for p in range(P))
    assert n == 1200


def test_multiprocess_bcd_train_metrics_agree(bcd):
    """The train rows (summed logloss, gathered AUC) are the same on every
    process, and on 2 and 3 processes."""
    _, outs, _ = bcd
    rows = {P: [[ln[ln.index("train:"):] for ln in out.splitlines()
                 if "bcd epoch" in ln and "train:" in ln] for out in outs[P]]
            for P in (2, 3)}
    for P in (2, 3):
        assert rows[P][0] and all(r == rows[P][0] for r in rows[P])
    a = [float(re.search(r"auc (\S+)", r).group(1)) for r in rows[2][0]]
    b = [float(re.search(r"auc (\S+)", r).group(1)) for r in rows[3][0]]
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_bcd_file_set_predicts_in_one_process(bcd):
    """The 2-process BCD set scores through the one-process SGD predict
    path (a LocalStore at K = 0) as the JAX checkpoint does."""
    tmp, _, _ = bcd
    out = {}
    for name in ("bcd2", "jax_bcd"):
        pred = tmp / f"pred_{name}.txt"
        assert cli.main([str(tmp / "fm.conf"), "V_dim=0", "task=predict",
                         f"model_in={tmp / name}",
                         f"data_in={tmp / 'val.svm'}", f"pred_out={pred}"],
                        device="cpu") == 0
        out[name] = np.loadtxt(pred)
    np.testing.assert_allclose(out["bcd2"], out["jax_bcd"], rtol=2e-4,
                               atol=2e-4)
