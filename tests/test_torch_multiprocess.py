"""The port's multi-process learner, CLI, predict and checkpoints against
the JAX package.

The port's CLI runs as 2 and 3 OS processes on the CPU under the JAX
package's env contract (``DIFACTO_COORDINATOR``, ``DIFACTO_NUM_PROCESSES``,
``DIFACTO_PROCESS_ID``; gloo, ``device="cpu"``), each launch under a
timeout that kills every process still running past it
(``difacto_tpu_torch.parallel.launch.run_processes``), on the data of
tests/test_multiprocess.py, whose fat head rows give the two input parts
unequal batch counts (the lockstep pads the shorter). Each run is held
against the JAX package's one-process emulation of the same global
stream (tests/test_multiprocess.py:135-199: the part streams zipped, the
shorter padded with empty batches, ``[p0 rows; p1 rows]`` a step) through
the JAX ShardedStore on a P-device CPU mesh (tests/conftest.py gives
eight), from one start table (``model_in``: the two packages draw their
initial factors from different generators), at the JAX package's
local-against-sharded tolerance, rtol and atol 2e-4, for the tables, the
metrics and the scores.

The launches are independent, so the module's fixture starts them all at
once; tests/torch_mp_ranks.py (no JAX) is the store-level rank program.
"""

import concurrent.futures as cf
import json
import pathlib
import re
import shutil

import jax
import numpy as np
import pytest

import torch_mp_ranks as R
from difacto_tpu.config import Config as JConfig
from difacto_tpu.data.batch_iter import Batch as JBatch
from difacto_tpu.data.batch_iter import BatchIter as JBatchIter
from difacto_tpu.data.prep import prep_batch_sharded as jprep_sharded
from difacto_tpu.data.synthetic import make_ctr_data, write_libffm, write_libsvm
from difacto_tpu.ops.metrics import exact_auc
from difacto_tpu.parallel.store import ShardedStore as JShardedStore
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu.utils import arg_parser as jarg_parser
from difacto_tpu.utils import checkpoint as jcheckpoint
from difacto_tpu_torch import cli
from difacto_tpu_torch.config import Config
from difacto_tpu_torch.parallel.launch import run_processes, run_ranks
from difacto_tpu_torch.parallel.store import LocalStore
from difacto_tpu_torch.updaters.updater import FMUpdater
from difacto_tpu_torch.utils import checkpoint
from difacto_tpu_torch.utils.checkpoint import state_to_numpy
from helpers import fm_leaves

TESTS = str(pathlib.Path(__file__).resolve().parent)
# the port's CLI on the CPU, as ``python -m difacto_tpu_torch`` runs it on
# the card
CLI = ["-c", "import sys; from difacto_tpu_torch import cli; "
       "sys.exit(cli.main(sys.argv[1:], device='cpu'))"]
# a launch's wall limit and its collectives' own: far above a healthy run
LAUNCH_TIMEOUT_S, GROUP_TIMEOUT_S = 240.0, 90.0
LEAVES = ("w", "z", "n", "V", "nV", "cnt")
TOL = dict(rtol=2e-4, atol=2e-4)


def launch(P: int, argv: list[str]) -> list[str]:
    return run_processes(argv, P, timeout=LAUNCH_TIMEOUT_S, path=TESTS,
                         env={"OMP_NUM_THREADS": "1"},
                         group_timeout=GROUP_TIMEOUT_S)


def start_state(k: int) -> dict[str, np.ndarray]:
    """The runs' start table over 2^12 rows: small random factors."""
    rng = np.random.default_rng(3 + k)
    n = 1 << 12
    s = {name: np.zeros(n, np.float32) for name in ("w", "z", "n", "cnt")}
    s["V"] = rng.uniform(-0.01, 0.01, (k, n)).astype(np.float32)
    s["nV"] = np.zeros((k, n), np.float32)
    return s


def write_data(tmp: pathlib.Path) -> None:
    """tests/test_multiprocess.py's data: the first 200 rows carry 40
    extra ids, so the byte midpoint is far from the row midpoint; and the
    start tables (JAX-format checkpoints) of the FM (K = 4) and the FFM
    (K = F*k = 12)."""
    for k in (4, 12):
        jcheckpoint.save(str(tmp / f"start{k}"),
                         JFMState(**start_state(k)), {"epoch": 0})
    blk = make_ctr_data(1200, num_fields=6, vocab_per_field=200, seed=5)
    train = tmp / "train.svm"
    write_libsvm(blk, str(train))
    lines = train.read_bytes().splitlines()
    fat = [ln + b" " + b" ".join(b"%d:1" % (10_000_000 + i * 50 + j)
                                 for j in range(40))
           for i, ln in enumerate(lines[:200])]
    train.write_bytes(b"\n".join(fat + lines[200:]) + b"\n")
    write_libsvm(make_ctr_data(400, num_fields=6, vocab_per_field=200,
                               seed=6), str(tmp / "val.svm"))
    write_libffm(make_ctr_data(1024, num_fields=6, vocab_per_field=150,
                               seed=11, with_fields=True,
                               shuffle_slots=True), str(tmp / "train.ffm"))
    (tmp / "fm.conf").write_text(f"""data_in = {train}
data_val = {tmp / "val.svm"}
batch_size = 256
num_bits = 12
max_nnz_per_row = 48
V_dim = 4
lr_eta = 0.1
l1 = 0.1
V_lr_eta = 0.05
max_num_epochs = 2
shuffle = 0
report_interval = 0
""")


# name -> (P, CLI overrides beyond fm.conf); every run starts from a
# start table (the tail filter's count pass runs without one)
RUNS = {
    "fm2": (2, ["model_in={tmp}/start4"]),
    "fm2_xla": (2, ["kernel=xla", "model_in={tmp}/start4"]),
    "fm2_planar_tail": (2, ["layout=planar", "tail_feature_filter=2",
                            "V_init_scale=0"]),
    "fm3": (3, ["batch_size=192", "max_num_epochs=1",
                "model_in={tmp}/start4"]),
    "ffm2": (2, ["data_in={tmp}/train.ffm", "data_val=", "data_format=libffm",
                 "loss=ffm", "num_fields=6", "V_dim=2", "max_num_epochs=1",
                 "model_in={tmp}/start12"]),
}


def run_argv(tmp, name: str) -> list[str]:
    P, extra = RUNS[name]
    return [str(tmp / "fm.conf"), *(e.format(tmp=tmp) for e in extra),
            f"model_out={tmp / name}"]


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    """Every launch of the module, at once: the training runs, the
    predict of fm2's checkpoint, the store-level rank program at P = 2 and
    3 (on a JAX-format file set), a batch size that P does not divide,
    and the learner on a two-rank group without the contract. Returns (tmp, {name: outputs or the error})."""
    tmp = tmp_path_factory.mktemp("mp_torch")
    write_data(tmp)
    write_jax_format_set(tmp / "jaxset")
    jobs = {name: (RUNS[name][0], CLI + run_argv(tmp, name))
            for name in RUNS}
    for P in (2, 3):
        (tmp / f"ranks{P}").mkdir()
        jobs[f"ranks{P}"] = (P, ["-c", "import sys, torch_mp_ranks as R; "
                                 "R.run(*sys.argv[1:])",
                                 str(tmp / f"ranks{P}"),
                                 str(tmp / "jaxset")])
    jobs["indivisible"] = (2, CLI + [str(tmp / "fm.conf"), "batch_size=255",
                                     f"model_out={tmp / 'never'}"])
    out = {}
    with cf.ThreadPoolExecutor(len(jobs) + 1) as pool:
        futs = {name: pool.submit(launch, *job) for name, job in jobs.items()}

        def predict():  # on fm2's checkpoint, once it is written
            futs["fm2"].result()
            return launch(2, CLI + [
                str(tmp / "fm.conf"), "task=predict",
                f"model_in={tmp / 'fm2'}", f"data_in={tmp / 'val.svm'}",
                f"pred_out={tmp / 'pred.txt'}"])

        futs["predict"] = pool.submit(predict)
        futs["global"] = pool.submit(
            run_ranks, "torch_mp_ranks:learner_global", 2,
            [str(tmp / "fm.conf"), str(tmp / "global")],
            timeout=LAUNCH_TIMEOUT_S, path=TESTS,
            group_timeout=GROUP_TIMEOUT_S)
        for name, f in futs.items():
            try:
                out[name] = f.result()
            except RuntimeError as e:
                out[name] = e
    return tmp, out


def outputs(mp, name: str) -> list[str]:
    got = mp[1][name]
    if isinstance(got, Exception):
        raise got
    return got


# -- the reference: the JAX store over the same global stream ---------------


def jax_config(tmp, name: str) -> JConfig:
    argv = [str(tmp / "fm.conf"), *(e.format(tmp=tmp)
                                    for e in RUNS[name][1])]
    cfg = JConfig.from_kwargs(jarg_parser.parse(argv))
    cfg.shard.num_shards = RUNS[name][0]
    cfg.shard.kernel = "xla"
    return cfg


def part_streams(cfg: JConfig, uri: str, P: int):
    """Each process's batches of ``uri`` (its byte-range part), zipped and
    the shorter padded with empty batches: the global stream."""
    d = cfg.data
    bs = d.batch_size // P
    streams = [list(JBatchIter(
        uri, batch_size=bs, max_nnz=d.max_nnz_per_row, num_bits=d.num_bits,
        data_format=d.data_format, part_index=[p], num_parts=P,
        shuffle=False, seed=d.seed)) for p in range(P)]
    L = d.max_nnz_per_row
    libffm = d.data_format == "libffm"
    empty = JBatch(np.full((bs, L), -1, np.int32),
                   np.zeros((bs, L), np.float32), np.zeros(bs, np.float32),
                   np.zeros(bs, np.float32),
                   fields=np.zeros((bs, L), np.int32) if libffm else None)
    n = max(len(s) for s in streams)
    padded = [s + [empty] * (n - len(s)) for s in streams]
    glob = [JBatch(*(np.concatenate([getattr(b, f) for b in step])
                     for f in ("ids", "vals", "labels", "mask")),
                   fields=(np.concatenate([b.fields for b in step])
                           if libffm else None))
            for step in zip(*padded)]
    return glob, [len(s) for s in streams]


_EMULATIONS: dict = {}


def emulation(tmp, name: str) -> dict:
    """The JAX ShardedStore on a P-device mesh over the run's global
    stream: the table after training (with the count pass first where the
    conf asks for one), and the validation pass's scores in each
    process's row order, its logloss and exact AUC."""
    if name in _EMULATIONS:
        return _EMULATIONS[name]
    cfg = jax_config(tmp, name)
    P = RUNS[name][0]
    mesh = jax.make_mesh((P,), ("shard",), devices=jax.devices()[:P])
    store = JShardedStore(JFMUpdater(cfg.effective_model_param()), cfg,
                          mesh=mesh)
    if cfg.learner.model_in:
        state, _ = jcheckpoint.load_for_store(cfg.learner.model_in, store)
    else:  # V_init_scale=0: the same zero table in both packages
        state = store.init_state(cfg.data.seed)
    nf = cfg.model.num_fields if cfg.expects_fields() else 0
    train, counts = part_streams(cfg, cfg.data.data_in, P)
    if cfg.model.tail_feature_filter > 0:
        for b in train:
            state = store.count_step(state, store.shard_batch(
                b.ids, b.vals, b.labels, b.mask)[0])

    def prepped(b):
        return jprep_sharded(b, store.num_rows, P,
                             fixed_ub=store.unique_size, num_fields=nf)

    for _ in range(cfg.learner.max_num_epochs):
        for b in train:
            state, _ = store.train_step_prepped(state, prepped(b))
    host = fm_leaves(state)
    res = {"leaves": {k: np.asarray(getattr(host, k)) for k in LEAVES},
           "part_batches": counts}
    if cfg.data.data_val:
        val, _ = part_streams(cfg, cfg.data.data_val, P)
        rows = [[] for _ in range(P)]
        ys = [[] for _ in range(P)]
        loss = n = 0.0
        for b in val:
            m, py = store.eval_step_prepped(state, prepped(b))
            loss += float(m.logloss_sum)
            n += float(m.examples)
            bs = b.mask.shape[0] // P
            for p in range(P):
                keep = b.mask[p * bs:(p + 1) * bs] > 0
                rows[p].append(np.asarray(py)[p * bs:(p + 1) * bs][keep])
                ys[p].append(b.labels[p * bs:(p + 1) * bs][keep])
        res["val_py"] = [np.concatenate(r) for r in rows]
        y = np.concatenate([np.concatenate(v) for v in ys])
        res["val_logloss"] = loss / n
        res["val_auc"] = exact_auc(y, np.concatenate(res["val_py"]))
    _EMULATIONS[name] = res
    return res


def valid_metrics(out: str) -> tuple[float, float]:
    """(logloss, exact_auc) of a process's last validation line."""
    line = [ln for ln in out.splitlines() if " valid: " in ln][-1]
    return (float(re.search(r"logloss (\S+)", line).group(1)),
            float(re.search(r"exact_auc (\S+)", line).group(1)))


def assert_table(got: dict, ref: dict, what: str) -> None:
    for leaf in LEAVES:
        a, b = got[leaf], ref[leaf]
        n = b.shape[-1]
        assert a.shape[-1] >= n, (what, leaf)
        assert not a[..., n:].any(), f"{what} {leaf}: padding rows"
        if b.size:
            np.testing.assert_allclose(a[..., :n], b, **TOL,
                                       err_msg=f"{what} {leaf}")


# -- the cases of tests/test_multiprocess.py ---------------------------------


def test_multiprocess_train_matches_jax_emulation(mp):
    """Two processes train fm.conf (kernel=auto: the row-major pairs, B3,
    K1) over unequal parts: the per-process checkpoint (meta: sharded, 2
    processes), read by the port's load_full, is the JAX emulation's
    table; each process's validation logloss and exact AUC are the
    emulation's."""
    tmp, _ = mp
    outs = outputs(mp, "fm2")
    ref = emulation(tmp, "fm2")
    assert len(set(ref["part_batches"])) > 1  # the lockstep padded
    meta = json.loads((tmp / "fm2.meta.json").read_text())
    assert meta["sharded"] and meta["process_count"] == 2
    assert sorted(p.name for p in tmp.glob("fm2.proc*.npz")) == [
        "fm2.proc0.npz", "fm2.proc1.npz"]
    host, _ = checkpoint.load_full(str(tmp / "fm2"))
    assert_table(state_to_numpy(host), ref["leaves"], "fm2")
    for out in outs:
        loss, auc = valid_metrics(out)
        assert loss == pytest.approx(ref["val_logloss"], rel=2e-4, abs=2e-4)
        assert auc == pytest.approx(ref["val_auc"], abs=2e-4)


def test_multiprocess_exact_auc_equal_on_every_process(mp):
    """The allgathered exact AUC: every process logs the same value, for
    every epoch, on 2 and on 3 processes."""
    for name in ("fm2", "fm3", "fm2_xla"):
        per = [[ln[ln.index("exact_auc"):] for ln in out.splitlines()
                if " valid: " in ln] for out in outputs(mp, name)]
        assert per[0] and all(p == per[0] for p in per), name
        assert 0.5 < float(per[0][-1].split()[1]) <= 1.0


def test_multiprocess_predict_part_files(mp):
    """task=predict on two processes: ``pred.txt.part0/1``, each its
    part's rows in order, concatenate to the JAX emulation's scores and
    to a one-process predict of the same file set loaded into a
    LocalStore (the topology-agnostic load); both processes log the
    metrics of all 400 rows."""
    tmp, _ = mp
    outs = outputs(mp, "predict")
    parts = [np.loadtxt(tmp / f"pred.txt.part{p}", ndmin=1) for p in (0, 1)]
    ref = emulation(tmp, "fm2")["val_py"]
    for p in (0, 1):
        np.testing.assert_allclose(parts[p], ref[p], **TOL)
    one = tmp / "pred_one.txt"
    assert cli.main([str(tmp / "fm.conf"), "task=predict",
                     f"model_in={tmp / 'fm2'}", f"data_in={tmp / 'val.svm'}",
                     f"pred_out={one}"], device="cpu") == 0
    np.testing.assert_allclose(np.concatenate(parts), np.loadtxt(one), **TOL)
    for out in outs:
        assert "predict: #ex 400" in out


def test_multiprocess_pairs_matches_xla(mp):
    """kernel=auto (pairs) and kernel=xla on two processes train the same
    table, and each the JAX emulation's."""
    tmp, _ = mp
    outputs(mp, "fm2_xla")
    a, _ = checkpoint.load_full(str(tmp / "fm2"))
    b, _ = checkpoint.load_full(str(tmp / "fm2_xla"))
    a, b = state_to_numpy(a), state_to_numpy(b)
    for leaf in LEAVES:
        np.testing.assert_allclose(a[leaf], b[leaf], **TOL, err_msg=leaf)
    assert_table(b, emulation(tmp, "fm2")["leaves"], "fm2_xla")


def test_multiprocess_planar_with_count_pass(mp):
    """layout=planar (K1 on planar leaves) with the tail filter's count
    pass in lockstep, against the emulation with its count pass."""
    tmp, _ = mp
    outputs(mp, "fm2_planar_tail")
    host, _ = checkpoint.load_full(str(tmp / "fm2_planar_tail"))
    assert_table(state_to_numpy(host),
                 emulation(tmp, "fm2_planar_tail")["leaves"],
                 "fm2_planar_tail")


def test_multiprocess_ffm_pairs(mp):
    """FFM with explicit libffm fields on two processes: the fields ride
    each process's prepped batches; the table is the emulation's."""
    tmp, _ = mp
    outputs(mp, "ffm2")
    host, meta = checkpoint.load_full(str(tmp / "ffm2"))
    assert meta["shapes"]["V"][0] == 12  # F*k
    assert_table(state_to_numpy(host), emulation(tmp, "ffm2")["leaves"],
                 "ffm2")


def test_three_processes(mp):
    """Three processes (a padded table: 3 does not divide 2^12): the
    table is the emulation's on a 3-device mesh, every process logs the
    same AUC, and the 3-file set loads into a one-process LocalStore."""
    tmp, _ = mp
    outs = outputs(mp, "fm3")
    ref = emulation(tmp, "fm3")
    host, meta = checkpoint.load_full(str(tmp / "fm3"))
    assert meta["process_count"] == 3 and host.w.shape[0] > 1 << 12
    assert_table(state_to_numpy(host), ref["leaves"], "fm3")
    for out in outs:
        loss, auc = valid_metrics(out)
        assert loss == pytest.approx(ref["val_logloss"], rel=2e-4, abs=2e-4)
        assert auc == pytest.approx(ref["val_auc"], abs=2e-4)
    cfg = Config.from_kwargs([("batch_size", "192"), ("num_bits", "12"),
                              ("max_nnz_per_row", "48"), ("V_dim", "4")])
    loc = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    st, meta = checkpoint.load_for_store(str(tmp / "fm3"), loc)
    got = state_to_numpy(st)
    for leaf in LEAVES:
        np.testing.assert_array_equal(
            got[leaf], state_to_numpy(host)[leaf][..., :1 << 12], leaf)


# -- the launch contract, the store and the checkpoints ---------------------


def test_store_auto_is_sharded_and_local_refused_under_the_contract(mp):
    """Under the contract ``store=auto`` is a ShardedStore of one shard a
    process taking each process's own rows, and ``store=local`` raises
    ValueError: a multi-process launch shards the table. ``hot_rows``
    raises ValueError when the store is made, where the JAX package's
    multi-process save of its split state fails with an AttributeError
    (difacto_tpu/utils/checkpoint.py:183-190)."""
    tmp, _ = mp
    for P in (2, 3):
        outputs(mp, f"ranks{P}")
        for r in range(P):
            got = np.load(tmp / f"ranks{P}" / f"rank{r}.npz")
            assert int(got["S"]) == P and bool(got["local_rows"])
            assert "shards the table" in str(got["local_error"])
            assert "hot_rows" in str(got["hot_error"])


def test_capacity_agreed_by_allgather(mp):
    """Each process preps its own rows, whose largest bucket fill differs
    from process to process; the pairs capacity and the epoch pin are
    the same on every rank, the ladder rung of the largest fill."""
    tmp, _ = mp
    for P in (2, 3):
        outputs(mp, f"ranks{P}")
        got = [np.load(tmp / f"ranks{P}" / f"rank{r}.npz") for r in range(P)]
        fills = [int(g["local_fill"]) for g in got]
        assert len(set(fills)) == P  # the ranks' own needs differ
        want = R.ladder(-(-max(fills) // 128) * 128)
        assert {int(g["capacity"]) for g in got} == {want}
        assert {int(g["pin"]) for g in got} == {-(-max(fills) // 128) * 128}


def test_batch_size_not_divided_by_the_processes_raises(mp):
    tmp, out = mp
    err = out["indivisible"]
    assert isinstance(err, RuntimeError)
    assert "must divide batch_size 255" in str(err)
    assert not list(tmp.glob("never*"))


def test_lone_process_join_times_out(tmp_path):
    """A process whose peers never come raises within the group timeout
    instead of hanging."""
    import subprocess
    import sys

    from difacto_tpu_torch.parallel.launch import free_port

    env = {**__import__("os").environ, "DIFACTO_NUM_PROCESSES": "2",
           "DIFACTO_COORDINATOR": f"localhost:{free_port()}",
           "DIFACTO_PROCESS_ID": "0", "DIFACTO_GROUP_TIMEOUT": "2"}
    r = subprocess.run([sys.executable, "-c",
                        "from difacto_tpu_torch.parallel.multihost import "
                        "maybe_initialize_distributed as m; m()"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "imed out" in r.stderr


# -- checkpoints across the packages -----------------------------------------


def write_jax_format_set(prefix: pathlib.Path) -> None:
    """A JAX-format per-process file set of 2 x 2 pieces (two processes of
    two devices, ``difacto_tpu/utils/checkpoint.py:161-205``), written
    with the JAX package's own key function, of R.jax_set_leaves()."""
    leaves = R.jax_set_leaves()
    n = leaves["w"].shape[0]
    cuts = np.linspace(0, n, 5).astype(int)
    for p in (0, 1):
        payload = {}
        for name, arr in leaves.items():
            for d in (2 * p, 2 * p + 1):
                sl = slice(int(cuts[d]), int(cuts[d + 1]))
                index = ((slice(None), sl) if arr.ndim == 2 else (sl,))
                payload[jcheckpoint._index_key(name, index, arr.shape)] = (
                    arr[index])
        np.savez(f"{prefix}.proc{p}.npz", **payload)
    meta = {"format_version": 1, "epoch": 1, "sharded": True,
            "process_count": 2,
            "shapes": {k: list(v.shape) for k, v in leaves.items()}}
    pathlib.Path(f"{prefix}.meta.json").write_text(json.dumps(meta))


def test_port_file_set_read_by_jax_load_full(mp):
    """The port's 2- and 3-process file sets read by JAX's load_full give
    the port's load_full arrays exactly."""
    tmp, _ = mp
    for name in ("fm2", "fm3"):
        outputs(mp, name)
        ref, jmeta = jcheckpoint.load_full(str(tmp / name))
        got, meta = checkpoint.load_full(str(tmp / name))
        assert jmeta == meta
        got = state_to_numpy(got)
        for leaf in LEAVES:
            np.testing.assert_array_equal(got[leaf],
                                          np.asarray(getattr(ref, leaf)),
                                          f"{name} {leaf}")


def test_jax_file_set_read_by_the_port(mp):
    """A JAX-format set of 2 x 2 pieces: the port's load_full gives the
    arrays exactly; load_for_store gives a LocalStore (one rank) the
    whole table and each rank of 2 and 3 its rows, zero past the hash
    space."""
    tmp, _ = mp
    want = R.jax_set_leaves()
    host, meta = checkpoint.load_full(str(tmp / "jaxset"))
    assert meta["epoch"] == 1
    host = state_to_numpy(host)
    for leaf in LEAVES:
        np.testing.assert_array_equal(host[leaf], want[leaf], leaf)
    cfg = Config.from_kwargs(R.STORE_KEYS)
    loc = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    got = state_to_numpy(checkpoint.load_for_store(str(tmp / "jaxset"),
                                                   loc)[0])
    for leaf in LEAVES:
        np.testing.assert_array_equal(got[leaf], want[leaf], leaf)
    n = want["w"].shape[0]
    for P in (2, 3):
        outputs(mp, f"ranks{P}")
        for r in range(P):
            g = np.load(tmp / f"ranks{P}" / f"rank{r}.npz")
            lo, rows = int(g["lo"]), int(g["rows"])
            for leaf in LEAVES:
                a = g[leaf]
                assert a.shape[-1] == rows
                hi = min(lo + rows, n)
                np.testing.assert_array_equal(
                    a[..., :hi - lo], want[leaf][..., lo:hi], f"{P} {leaf}")
                assert not a[..., hi - lo:].any()


def test_missing_top_range_proc_file_raises(mp, tmp_path):
    """A set whose meta says 2 processes but whose proc1 file is gone
    fails the coverage check in every load (it would otherwise truncate
    the model), and a stale proc2 file past the count is not read."""
    tmp, _ = mp
    outputs(mp, "fm2")
    prefix = tmp_path / "cut"
    shutil.copy(tmp / "fm2.meta.json", f"{prefix}.meta.json")
    shutil.copy(tmp / "fm2.proc0.npz", f"{prefix}.proc0.npz")
    shutil.copy(tmp / "fm2.proc1.npz", f"{prefix}.proc2.npz")  # stale
    with pytest.raises(ValueError, match="do not cover"):
        checkpoint.load_full(str(prefix))
    cfg = Config.from_kwargs([("num_bits", "12"), ("V_dim", "4")])
    loc = LocalStore(FMUpdater(cfg.model), cfg, device="cpu")
    with pytest.raises(ValueError, match="do not cover"):
        checkpoint.load_for_store(str(prefix), loc)
    with pytest.raises(ValueError, match="load_full"):
        checkpoint.load(str(prefix))
    shutil.copy(tmp / "fm2.proc1.npz", f"{prefix}.proc1.npz")
    big = Config.from_kwargs([("num_bits", "13"), ("V_dim", "4")])
    with pytest.raises(ValueError, match="hash space"):
        checkpoint.load_for_store(str(prefix), LocalStore(
            FMUpdater(big.model), big, device="cpu"))
    other_k = Config.from_kwargs([("num_bits", "12"), ("V_dim", "3")])
    with pytest.raises(ValueError, match="V_dim"):
        checkpoint.load_for_store(str(prefix), LocalStore(
            FMUpdater(other_k.model), other_k, device="cpu"))


def test_learner_on_a_group_without_the_contract(mp, tmp_path):
    """SGDLearner on the ranks of a ``run_ranks`` group (no launch
    contract): every rank steps its row group of the same global batches,
    and rank 0 alone writes the gathered table, which is a one-process
    ``store=local`` run's."""
    tmp, _ = mp
    outputs(mp, "global")
    assert not list(tmp.glob("global.proc*"))
    got, meta = checkpoint.load(str(tmp / "global"))
    assert not meta.get("sharded")
    model = tmp_path / "local"
    assert cli.main([str(tmp / "fm.conf"), "store=local",
                     f"model_out={model}"], device="cpu") == 0
    ref, _ = checkpoint.load(str(model))
    got, ref = state_to_numpy(got), state_to_numpy(ref)
    for leaf in LEAVES:
        np.testing.assert_allclose(got[leaf], ref[leaf], **TOL, err_msg=leaf)
