"""AutoInt's model module (fmbench/models/autoint.py) on the CPU, at a tiny
size with the published widths (39 fields, d = 16, three layers of two
heads of d' = 32):

    python -m pytest fmbench/tests/test_autoint_module.py -q

A temporary checkout holds a copy of ``fmbench/`` and a tiny AutoInt cell
added as files (the configuration with a small table and batch, the
traffic at 32 rows, the full-size cell's limits). The program runs its
kernels' plain versions on the CPU and agrees with the module's reference;
the reference against itself with a planted fault (a dense gradient scaled,
its sign turned or its entries shuffled) reads ``correct`` false;
a reference that leaves out a dense leaf's change stops the run.
"""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
HERE = REPO / "fmbench"
sys.path.insert(0, str(REPO))

from fmbench import check, control, run  # noqa: E402

CELL = "autoint_tiny.replay"
FULL = "autoint_criteo.replay"
SEED = 2 ** 31 + 777
LOST = "autoint_lost_tiny.replay"
LOST_SOURCE = '''"""AutoInt whose reference leaves out the second layer's change."""
from fmbench.models.autoint import (  # noqa: F401
    ATTN, DENSE, KERNELS, LEAVES, Model, keep, place, shape, step_bytes,
    step_flops)
from fmbench.models import autoint


def reference(*a, **k):
    out = autoint.reference(*a, **k)
    del out["change_attn1"]
    return out
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, r / "fmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    full = next(w for w in spec["workloads"] if w["name"] == FULL)
    conf = json.loads((HERE / "configs" / "autoint_criteo.json").read_text())
    conf["conf"].update(num_bits=12)
    traf = json.loads((HERE / "traffic" / f"{full['traffic']}.json")
                      .read_text())
    traf.update(batch_size=32, batches=4, vocab_per_field=50)
    fm = r / "fmbench"
    (fm / "configs" / "autoint_tiny.json").write_text(json.dumps(conf))
    (fm / "traffic" / "tiny_libffm.json").write_text(json.dumps(traf))
    (fm / "models" / "autoint_lost.py").write_text(LOST_SOURCE)
    lost = dict(conf, name="autoint_lost_tiny", model="autoint_lost")
    (fm / "configs" / "autoint_lost_tiny.json").write_text(json.dumps(lost))
    spec["configs"], spec["workloads"] = [], []
    for cell in (CELL, LOST):
        cname = cell.split(".")[0]
        shutil.copy(HERE / "limits" / f"{FULL}.json",
                    fm / "limits" / f"{cell}.json")
        spec["configs"].append({"name": cname, "source": "a test",
                                "reduced": [], "why": "a test",
                                "file": f"fmbench/configs/{cname}.json"})
        spec["workloads"].append({"name": cell, "config": cname,
                                  "traffic": "tiny_libffm", "chips": 1,
                                  "why": "a test"})
    spec["per_layer"] = [dict(m, workloads=[CELL])
                         for m in spec["per_layer"]
                         if m.get("workloads") == [FULL]]
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    return r


def _run(root, cell, traced=False):
    return run.run_cell(root, cell, SEED, 0.2, traced, "cpu",
                        time.perf_counter())[0]


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_is_correct(root, traced):
    """The program on the CPU agrees with the module's reference within
    the full-size cell's limits; the per-layer readers, which read the
    device trace, give nothing on the CPU."""
    out = _run(root, CELL, traced)
    assert out["correct"], out["checks"]
    if traced:
        assert out["metrics"] == {}
        assert out["bound_by"]["step_mfu.train"] == ["operations"]


def test_module_reads_every_leaf(root):
    cell = run.load_cell(root, CELL)
    mod = run.load_model(root, cell.config)
    m = mod.Model.of(cell.config["conf"])
    rows = run.traffic.make_rows(cell.traffic, SEED, "cpu")
    ref = mod.reference(SEED, run.first_batches(rows), m, "cpu")
    assert mod.LEAVES == ("w", "V", "attn0", "attn1", "attn2", "out")
    assert set(ref) == ({"loss", "grad_V", "change_w", "change_V"}
                        | {f"{k}_{d}" for k in ("grad", "change")
                           for d in mod.DENSE})
    assert ref["change_w"] == 0.0  # w takes no part
    assert m.size == 39361


def test_reference_without_a_dense_change_stops_the_run(root):
    with pytest.raises(KeyError, match="change_attn1"):
        _run(root, LOST)


@pytest.mark.parametrize("leaf", ["attn0", "out"])
def test_altered_dense_gradient_is_not_correct(root, monkeypatch, leaf):
    """The reference against itself, one dense leaf's gradient scaled by
    1.001 before Adam takes it: ``correct`` false."""
    cell = run.load_cell(root, CELL)
    mod = run.load_model(root, cell.config)
    m = mod.Model.of(cell.config["conf"])
    first = run.first_batches(run.traffic.make_rows(cell.traffic, SEED,
                                                    "cpu"))
    sound = mod.reference(SEED, first, m, "cpu")
    adam = mod._Trainer._adam

    def altered(self, g):
        g = g.clone()
        g[m.leaves()[leaf]] *= 1.001
        return adam(self, g)

    monkeypatch.setattr(mod._Trainer, "_adam", altered)
    numbers = check.compare(mod.reference(SEED, first, m, "cpu"), sound,
                            mod.LEAVES)
    assert not all(check.judge(numbers, cell.limits).values()), numbers


@pytest.mark.parametrize("turn", ["sign", "shuffled"])
@pytest.mark.parametrize("leaf", ["attn0", "attn1", "attn2", "out"])
def test_turned_dense_gradient_is_not_correct(root, monkeypatch, leaf, turn):
    """The reference against itself, one dense leaf's gradient with its
    sign turned or its entries shuffled before Adam takes it, its norm
    unchanged: ``grad`` reads the turn (through Adam's first moment against
    the leaf's seeded direction), and ``correct`` is false."""
    cell = run.load_cell(root, CELL)
    mod = run.load_model(root, cell.config)
    m = mod.Model.of(cell.config["conf"])
    first = run.first_batches(run.traffic.make_rows(cell.traffic, SEED,
                                                    "cpu"))
    sound = mod.reference(SEED, first, m, "cpu")
    adam = mod._Trainer._adam
    sl = m.leaves()[leaf]
    gen = torch.Generator().manual_seed(5)

    def turned(self, g):
        g = g.clone()
        if turn == "sign":
            g[sl] = -g[sl]
        else:
            g[sl] = g[sl][torch.randperm(sl.stop - sl.start, generator=gen)]
        return adam(self, g)

    monkeypatch.setattr(mod._Trainer, "_adam", turned)
    numbers = check.compare(mod.reference(SEED, first, m, "cpu"), sound,
                            mod.LEAVES)
    assert numbers["grad"] > cell.limits["grad"], numbers


def test_program_dense_gradient_turned_is_not_correct(root, monkeypatch):
    """The program's second layer's gradient with its sign turned where
    its loss writes it: the run reads ``correct`` false, by ``grad``."""
    from difacto_tpu_torch.learners import step

    orig = step.autoint_loss_grad

    def turned(*a, **k):
        out = orig(*a, **k)
        g = a[-1].grad
        g[16 * 256:16 * 256 + 64 * 256].neg_()     # attn1's W
        return out

    monkeypatch.setattr(step, "autoint_loss_grad", turned)
    out = _run(root, CELL)
    assert not out["correct"], out["checks"]
    assert out["checks"]["grad"]["value"] > out["checks"]["grad"]["limit"]


def test_program_dense_gradient_altered_is_not_correct(root, monkeypatch):
    """The program's own dense gradient altered where its loss writes it:
    the run reads ``correct`` false."""
    from difacto_tpu_torch.learners import step

    orig = step.autoint_loss_grad

    def altered(*a, **k):
        out = orig(*a, **k)
        a[-1].grad[-1] *= 1.001     # the output's bias
        return out

    monkeypatch.setattr(step, "autoint_loss_grad", altered)
    out = _run(root, CELL)
    assert not out["correct"], out["checks"]


def test_control_readings_are_not_correct(root):
    """The reference in bfloat16, half of each batch left out, an
    unchanged state: each fails a limit."""
    got = control.readings(root, CELL, 11, torch.device("cpu"))
    limits = run.load_cell(root, CELL).limits
    for name, numbers in got.items():
        assert not all(check.judge(numbers, limits).values()), (name,
                                                                numbers)
