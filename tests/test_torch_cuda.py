"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA card and skip without one: the kernels have no
CPU mode. The file imports nothing of JAX, so on the card it runs without
the JAX package's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

(chip_smoke.py repeats the comparison at the flagship shapes.) The NumPy
input makers here are shared with tests/test_torch_kernels.py, which holds
the plain versions against the JAX kernels on the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from difacto_tpu_torch.config import FMParam
from difacto_tpu_torch.ops import cuda, pair_sweep, segsum, sweep, sweep_ms
from difacto_tpu_torch.probes import bench_slot_accum as slot_probe
from difacto_tpu_torch.probes import bisect_apply as bisect_probe
from difacto_tpu_torch.probes import hw_packed_pairs as packed_probe
from difacto_tpu_torch.updaters.updater import (FMUpdater, pack_state,
                                                unpack_state)
from difacto_tpu_torch.utils.checkpoint import state_from_numpy

torch.set_num_threads(2)

LEAVES = ("w", "z", "n", "cnt", "V", "nV")
N, U = 4096, 384
N2, R2 = 2048, 512  # the multi-stream sweep case: 4 table blocks


def port_params(**kw) -> FMParam:
    p = FMParam()
    for k, v in {**dict(V_threshold=2, l1=0.1, lr_eta=0.1), **kw}.items():
        setattr(p, k, v)
    return p


def state_np(K, rng, cnt_frac=0.5, n=N):
    """A trained-looking planar state: nonzero w/z/n/nV and counts on
    both sides of the V threshold."""
    return {
        "w": rng.normal(size=n).astype(np.float32) * 0.1,
        "z": rng.normal(size=n).astype(np.float32),
        "n": rng.random(n).astype(np.float32),
        "cnt": ((rng.random(n) < cnt_frac) * 3).astype(np.float32),
        "V": rng.uniform(-0.01, 0.01, (K, n)).astype(np.float32),
        "nV": rng.random((K, n)).astype(np.float32),
    }


def sorted_uids(rng, repeat=False):
    """Sorted, sentinel-padded ids (the prep.py contract); the last U/8
    lanes are sentinels. ``repeat`` makes runs of equal ids (the sharded
    owner-side stream's form)."""
    n_valid = U - U // 8
    if repeat:
        raw = np.sort(rng.choice(N, size=n_valid // 3, replace=False))
        raw = np.sort(np.concatenate([raw, raw[::2], raw[::5]]))[:n_valid]
        n_valid = raw.shape[0]
    else:
        raw = np.sort(rng.choice(N, size=n_valid, replace=False))
    uids = np.full(U, N, np.int32)
    uids[:n_valid] = raw
    return uids, np.arange(U) < n_valid


def payload(K, valid, rng):
    """The apply payload gw | gV | add_cnt | touch, zero on invalid lanes."""
    vf = valid.astype(np.float32)
    grads = rng.normal(size=(1 + K, U)).astype(np.float32) * valid
    addc = rng.integers(1, 4, U).astype(np.float32) * vf
    return np.concatenate([grads, addc[None], vf[None]], axis=0)


def id_streams(rng, lens=(300, 200), pad=24):
    """Sorted id streams laid end to end (the sweep kernels' ``sid``),
    each with repeats and a sentinel tail, drawn from one pool so ids
    also repeat across streams; table block 2 of 4 gets no id. Returns
    (sid i32 [NNZ], offsets i32 [S, N2/R2 + 1]): each stream's
    searchsorted block boundaries."""
    pool = rng.choice(np.r_[0 : 2 * R2, 3 * R2 : N2], size=150,
                      replace=False)
    nb = N2 // R2
    parts, offs, pos = [], [], 0
    for n in lens:
        ids = np.r_[np.sort(rng.choice(pool, size=n)), np.full(pad, N2)]
        offs.append(np.searchsorted(ids, np.arange(nb + 1) * R2) + pos)
        parts.append(ids)
        pos += ids.shape[0]
    return (np.concatenate(parts).astype(np.int32),
            np.stack(offs).astype(np.int32))


def slot_payload(K, nnz, rng, integer=False):
    """gw | gV | add_cnt | touch on every slot, the sentinel slots
    included (the kernels must ignore them). Floats: touch is 0 on a fifth
    of the slots, so some rows get counts but no update. ``integer``: all
    rows in [1, 8], whose sums are exact in float32."""
    if integer:
        return rng.integers(1, 9, (3 + K, nnz)).astype(np.float32)
    grads = rng.normal(size=(1 + K, nnz)).astype(np.float32)
    addc = rng.integers(1, 4, nnz).astype(np.float32)
    touch = (rng.random(nnz) < 0.8).astype(np.float32)
    return np.concatenate([grads, addc[None], touch[None]], axis=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them at full size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("K", [0, 4, 96])
def test_cuda_pull_matches_plain(card, K):
    rng = np.random.default_rng(30 + K)
    p = port_params(V_dim=K)
    st = state_from_numpy(state_np(K, rng), device=card)
    uids = torch.from_numpy(sorted_uids(rng)[0]).to(card)
    n0 = cuda.LAUNCHES["pull_pairs"]
    got = pair_sweep.pull_pairs(st, uids, p)
    assert cuda.LAUNCHES["pull_pairs"] == n0 + 1
    assert torch.equal(got, pair_sweep.pull_pairs_plain(st, uids, p))


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (2, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2),
                                             (96, "ftrl", "adagrad", 0)])
@pytest.mark.parametrize("repeat", [False, True])
def test_cuda_apply_matches_plain(card, K, wupd, vupd, tff, repeat):
    rng = np.random.default_rng(40 + K)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng)
    uids, valid = sorted_uids(rng, repeat=repeat)
    pay = torch.from_numpy(payload(K, valid, rng)).to(card)
    uids = torch.from_numpy(uids).to(card)
    n0 = cuda.LAUNCHES["apply_pairs"]
    a = pair_sweep.apply_pairs(state_from_numpy(s, card), uids, pay, p)
    assert cuda.LAUNCHES["apply_pairs"] == n0 + 1
    b = pair_sweep.apply_pairs_plain(state_from_numpy(s, card), uids, pay, p)
    for name in LEAVES:
        # the plain version's division by a scalar runs as a multiply by
        # its float reciprocal on the card: 1 ulp
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=1e-5, atol=1e-6, msg=name)


def test_cuda_segsum_matches_plain(card):
    rng = np.random.default_rng(50)
    bl, ub, pp = 20000, 4096, 18
    # a power-law lane stream: one hot lane spans many 512-slot chunks
    lanes = np.sort(np.minimum(rng.zipf(1.3, bl) - 1, 3000)).astype(np.int32)
    inv_p = segsum.pad_sorted_stream(lanes)
    pay = rng.normal(size=(pp, inv_p.shape[0])).astype(np.float32)
    pay[:, bl:] = 0.0
    pay_t = torch.from_numpy(pay).to(card)
    lanes_t = torch.from_numpy(inv_p).to(card)
    n0 = cuda.LAUNCHES["segsum_sorted"]
    got = segsum.segsum_sorted(pay_t, lanes_t, ub)
    assert cuda.LAUNCHES["segsum_sorted"] == n0 + 1
    # against the float64 sums: any float32 order is within
    # (n-1) * 2^-24 * sum|x| over a segment of n slots
    ref = segsum.segsum_sorted_plain(pay_t.double(), lanes_t, ub)
    seg_n = torch.bincount(lanes_t.long(), minlength=ub).double()
    abs_sum = segsum.segsum_sorted_plain(pay_t.abs().double(), lanes_t, ub)
    tol = (seg_n - 1).clamp(min=0) * 2.0 ** -24 * abs_sum
    assert bool(((got.double() - ref).abs() <= tol).all())
    covered = np.zeros(ub, bool)
    covered[lanes] = True
    assert bool((got[:, torch.from_numpy(~covered).to(card)] == 0).all())


def test_cuda_segsum_exact_on_integers(card):
    # integers in [1, 8] sum exactly in float32 (every total < 2^24), so a
    # chunk piece of the hot lane (~100 chunks here) lost or added twice
    # shows, however long its segment
    rng = np.random.default_rng(51)
    bl, ub, pp = 200000, 4096, 18
    lanes = np.sort(np.minimum(rng.zipf(1.3, bl) - 1, 3000)).astype(np.int32)
    inv_p = segsum.pad_sorted_stream(lanes)
    pay = rng.integers(1, 9, size=(pp, inv_p.shape[0])).astype(np.float32)
    pay[:, bl:] = 0.0
    pay_t = torch.from_numpy(pay).to(card)
    lanes_t = torch.from_numpy(inv_p).to(card)
    got = segsum.segsum_sorted(pay_t, lanes_t, ub)
    assert torch.equal(got, segsum.segsum_sorted_plain(pay_t, lanes_t, ub))


@pytest.mark.parametrize("K", [0, 4, 40, 96])
@pytest.mark.parametrize("lens", [(300,), (300, 200)])
def test_cuda_sweep_pull_matches_plain(card, K, lens):
    rng = np.random.default_rng(60 + K + len(lens))
    p = port_params(V_dim=K)
    st = state_from_numpy(state_np(K, rng, n=N2), device=card)
    sid, off = (torch.from_numpy(a).to(card) for a in id_streams(rng, lens))
    n0 = cuda.LAUNCHES["sweep_pull"]
    got = sweep_ms.sweep_pull_ms(st, sid, off, p, block_rows=R2)
    assert cuda.LAUNCHES["sweep_pull"] == n0 + 1
    ref = sweep_ms.sweep_pull_ms_plain(st, sid, off, p, block_rows=R2)
    assert torch.equal(got, ref)  # a gather with a mask: exact
    assert bool((got[:, sid == N2] == 0).all())


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (40, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2),
                                             (96, "ftrl", "adagrad", 0)])
@pytest.mark.parametrize("lens", [(300,), (300, 200)])
def test_cuda_sweep_apply_matches_plain(card, K, wupd, vupd, tff, lens):
    rng = np.random.default_rng(70 + K + len(lens))
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng, n=N2)
    sid, off = (torch.from_numpy(a).to(card) for a in id_streams(rng, lens))
    pay = torch.from_numpy(slot_payload(K, sid.shape[0], rng)).to(card)
    n0 = cuda.LAUNCHES["sweep_apply"]
    a = sweep_ms.sweep_apply_ms(state_from_numpy(s, card), sid, pay, off, p,
                                block_rows=R2)
    assert cuda.LAUNCHES["sweep_apply"] == n0 + 1
    b = sweep_ms.sweep_apply_ms_plain(state_from_numpy(s, card), sid, pay,
                                      off, p, block_rows=R2)
    for name in LEAVES:
        # slot sums in another order than index_add_'s atomics, and the
        # plain version's division by a scalar as a multiply by its
        # reciprocal: a few ulp
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=1e-5, atol=1e-6, msg=name)


def test_cuda_sweep_apply_exact_on_integers(card):
    """Integer payload in [1, 8] through SGD with unit rates, no decay and
    a zero table: w = -sum(gw), V = -sum(gV), cnt += sum(add_cnt), all
    exact in float32, so a slot lost or added twice fails."""
    rng = np.random.default_rng(80)
    K = 5
    p = port_params(V_dim=K, w_updater="sgd", V_updater="sgd", lr_eta=1.0,
                    l2=0.0, V_lr_eta=1.0, V_l2=0.0, V_threshold=0)
    s = {k: np.zeros_like(v) for k, v in state_np(K, rng, n=N2).items()}
    sid, off = (torch.from_numpy(a).to(card) for a in id_streams(rng))
    pay = torch.from_numpy(slot_payload(K, sid.shape[0], rng,
                                        integer=True)).to(card)
    a = sweep_ms.sweep_apply_ms(state_from_numpy(s, card), sid, pay, off, p,
                                block_rows=R2)
    b = sweep_ms.sweep_apply_ms_plain(state_from_numpy(s, card), sid, pay,
                                      off, p, block_rows=R2)
    for name in LEAVES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert bool((a.cnt > 0).any())


_UNSORTED = """
import sys
import numpy as np
import torch
from difacto_tpu_torch.ops import sweep_ms
from difacto_tpu_torch.utils.checkpoint import state_from_numpy
from test_torch_cuda import N2, R2, id_streams, port_params, slot_payload, state_np

rng = np.random.default_rng(0)
p = port_params(V_dim=4)
st = state_from_numpy(state_np(4, rng, n=N2), device="cuda")
sid, off = id_streams(rng)
j = int(np.flatnonzero(np.diff(sid[: off[0, -1]]) > 0)[0])
sid[j], sid[j + 1] = sid[j + 1], sid[j]  # a descent inside stream 0
pay = torch.from_numpy(slot_payload(4, sid.shape[0], rng)).cuda()
sid, off = torch.from_numpy(sid).cuda(), torch.from_numpy(off).cuda()
if sys.argv[2:] == ["packed"]:
    from difacto_tpu_torch.updaters.updater import pack_state
    st = pack_state(st)
if sys.argv[1] == "pull":
    sweep_ms.sweep_pull_ms(st, sid, off, p, block_rows=R2)
else:
    sweep_ms.sweep_apply_ms(st, sid, pay, off, p, block_rows=R2)
torch.cuda.synchronize()
"""


@pytest.mark.parametrize("kernel", ["pull", "apply"])
def test_cuda_sweep_traps_on_an_unsorted_stream(card, kernel):
    """The sweep kernels binary-search each stream, so a descent inside a
    stream's covered range traps. A device-side assert ends the
    process's CUDA context, hence the subprocess."""
    here = pathlib.Path(__file__).resolve().parent
    r = subprocess.run(
        [sys.executable, "-c", _UNSORTED, kernel], cwd=here.parent,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(here.parent), str(here)])},
    )
    out = r.stdout + r.stderr
    assert r.returncode != 0, out
    assert "device-side assert" in out or "must be sorted" in out, out


# ---------------------------------------------------------------------------
# the probes' kernels (difacto_tpu_torch/probes): apply_pairs2, the packed
# pull and apply, the bisect kernels, the slot accumulate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (2, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2)])
@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("design", ["lanes", "tiles"])
def test_cuda_apply2_matches_plain_and_apply_pairs(card, K, wupd, vupd, tff,
                                                   repeat, design):
    rng = np.random.default_rng(40 + K)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng)
    uids, valid = sorted_uids(rng, repeat=repeat)
    pay = torch.from_numpy(payload(K, valid, rng)).to(card)
    uids = torch.from_numpy(uids).to(card)
    n0 = cuda.LAUNCHES["apply_pairs2"]
    a = pair_sweep.apply_pairs2(state_from_numpy(s, card), uids, pay, p,
                                design)
    assert cuda.LAUNCHES["apply_pairs2"] == n0 + 1
    b = pair_sweep.apply_pairs2_plain(state_from_numpy(s, card), uids, pay, p)
    c = pair_sweep.apply_pairs(state_from_numpy(s, card), uids, pay, p)
    for name in LEAVES:
        # against the plain version: its division by a scalar runs as a
        # multiply by the reciprocal on the card, 1 ulp
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=1e-5, atol=1e-6, msg=name)
        # against B2's kernel: the same sums in the same order and the
        # same arithmetic, so the same bits
        assert torch.equal(getattr(a, name), getattr(c, name)), name


@pytest.mark.parametrize("u", [0, 1, 7])
@pytest.mark.parametrize("design", ["lanes", "tiles"])
def test_cuda_apply2_short_streams(card, u, design):
    """No lane, one lane and an odd count (a tile staged by 4-byte
    copies)."""
    rng = np.random.default_rng(45)
    K = 3
    p = port_params(V_dim=K, V_threshold=0)
    s = state_np(K, rng)
    uids = np.sort(rng.choice(N, size=u, replace=False)).astype(np.int32)
    pay = np.concatenate([rng.normal(size=(1 + K, u)), np.ones((2, u))]
                         ).astype(np.float32)
    uids = torch.from_numpy(uids).to(card)
    pay = torch.from_numpy(pay).to(card)
    a = pair_sweep.apply_pairs2(state_from_numpy(s, card), uids, pay, p,
                                design)
    b = pair_sweep.apply_pairs2_plain(state_from_numpy(s, card), uids, pay, p)
    for name in LEAVES:
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=1e-5, atol=1e-6, msg=name)
    assert int((a.cnt != torch.from_numpy(s["cnt"]).to(card)).sum()) == u


def tile_edge_case(K, rng, trim=0):
    """A stream across the planar apply's 128-lane tiles (csrc/
    planar_apply.cu), 1024 - ``trim`` lanes: unique ids; a run over lanes
    120..135 (across a tile edge); one id over lanes 200..520 (longer than
    a tile, over four); a tile of unique ids none touched (640..767); a
    tile of unique ids all below the V gate (768..895); sentinel lanes
    from 896 on (a whole sentinel tile when ``trim`` is 0). ``trim`` = 3
    makes U odd to 4, so the payload is staged by 4-byte copies. Returns
    (state leaves, uids, payload, the ids below the gate)."""
    runs = [1] * 120 + [16] + [1] * 64 + [321] + [1] * 119 + [1] * 256
    ids = np.repeat(5 * np.arange(len(runs)) + 1, runs)
    u = 1024 - trim
    uids = np.full(u, N, np.int32)
    uids[:ids.shape[0]] = ids
    vf = (uids < N).astype(np.float32)
    grads = rng.normal(size=(1 + K, u)).astype(np.float32) * vf
    addc = rng.integers(1, 4, u).astype(np.float32) * vf
    touch = vf.copy()
    touch[640:768] = 0.0
    pay = np.concatenate([grads, addc[None], touch[None]], axis=0)
    s = state_np(K, rng)
    s["cnt"][uids[uids < N]] = 3.0          # past the gate (V_threshold 2)
    cold = uids[768:896]
    s["cnt"][cold] = 1.0                    # below it
    return s, uids, pay, cold


def run_planar_apply(entry, s, uids, pay, p, card, stage):
    """One call of a planar-apply entry by the design or floor ``stage`` on
    a copy of ``s``; the state it updated, as planar leaves
    (``apply_packed`` in place on A and B)."""
    if entry == "apply_pairs2":
        st = state_from_numpy(s, card)
        out = pair_sweep.apply_pairs2(st, uids, pay, p, stage)
        assert out is st
        return out
    a, b = packed_probe.pack_state(state_from_numpy(s, card))
    a2, b2 = packed_probe.apply_packed(a, b, uids, pay, p, stage)
    assert a2 is a and b2 is b  # in place on A and B
    return packed_probe.unpack_state(a, b)


def assert_same_bits(got, ref):
    for name in LEAVES:
        x, y = getattr(got, name), getattr(ref, name)
        assert torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32)), name


@pytest.mark.parametrize("entry", ["apply_pairs2", "apply_packed"])
@pytest.mark.parametrize("design", ["lanes", "tiles"])
@pytest.mark.parametrize("K,wupd,vupd", [(4, "ftrl", "adagrad"),
                                         (0, "ftrl", "adagrad"),
                                         (3, "adagrad", "sgd"),
                                         (2, "sgd", "adagrad")])
@pytest.mark.parametrize("trim", [0, 3])
def test_cuda_planar_apply_across_tiles(card, entry, design, K, wupd, vupd,
                                        trim):
    """Both designs of each entry on runs across a tile edge and longer
    than a tile, a tile with no touched row, one with no row past the
    gate, sentinel tiles: the bits of B2's kernel, and its plain version's
    values (1 ulp: its scalar division is a multiply by the reciprocal on
    the card). The plain version runs on the CPU, where its index_add_
    sums each run in lane order as the kernels do; on the card it adds
    atomically, in another order each call, which over the 321-lane run
    moves nV by more than the tolerance. Untouched and below-gate rows
    keep what they must."""
    rng = np.random.default_rng(160 + K + trim)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd)
    s, uids_np, pay_np, cold = tile_edge_case(K, rng, trim)
    uids = torch.from_numpy(uids_np).to(card)
    pay = torch.from_numpy(pay_np).to(card)
    n0 = cuda.LAUNCHES[entry]
    got = run_planar_apply(entry, s, uids, pay, p, card, design)
    assert cuda.LAUNCHES[entry] == n0 + 1
    ref = pair_sweep.apply_pairs(state_from_numpy(s, card), uids, pay, p)
    plain = pair_sweep.apply_pairs_plain(state_from_numpy(s), uids.cpu(),
                                         pay.cpu(), p)
    assert_same_bits(got, ref)
    for name in LEAVES:
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(plain, name), rtol=1e-5,
                                   atol=1e-6, msg=name)
    untouched = torch.from_numpy(uids_np[640:768]).to(card).long()
    cold = torch.from_numpy(cold).to(card).long()
    for name in LEAVES:
        x0 = torch.from_numpy(s[name]).to(card)
        assert torch.equal(getattr(got, name)[..., untouched],
                           x0[..., untouched]), name
    if K:
        assert torch.equal(got.V[:, cold], torch.from_numpy(s["V"]).to(
            card)[:, cold])


@pytest.mark.parametrize("entry", ["apply_pairs2", "apply_packed"])
@pytest.mark.parametrize("K", [0, 4])
def test_cuda_planar_apply_floors_keep_every_bit(card, entry, K):
    """The tiles' floor ``rmwonly`` loads and stores back every leaf the
    update would touch and changes no bit; it counts as a launch of its
    entry."""
    rng = np.random.default_rng(170 + K)
    p = port_params(V_dim=K)
    s, uids_np, pay_np, _ = tile_edge_case(K, rng)
    uids = torch.from_numpy(uids_np).to(card)
    pay = torch.from_numpy(pay_np).to(card)
    n0 = cuda.LAUNCHES[entry]
    got = run_planar_apply(entry, s, uids, pay, p, card, "rmwonly")
    assert cuda.LAUNCHES[entry] == n0 + 1
    assert_same_bits(got, state_from_numpy(s, card))


_UNSORTED_PAIRS = """
import sys
import numpy as np
import torch
from difacto_tpu_torch.ops import pair_sweep
from difacto_tpu_torch.utils.checkpoint import state_from_numpy
from test_torch_cuda import payload, port_params, sorted_uids, state_np

rng = np.random.default_rng(0)
p = port_params(V_dim=4)
st = state_from_numpy(state_np(4, rng), device="cuda")
uids, valid = sorted_uids(rng)
uids[10], uids[11] = uids[11], uids[10]  # a descent
pay = torch.from_numpy(payload(4, valid, rng)).cuda()
kernel = sys.argv[1]
if kernel == "apply_rowmajor":
    from difacto_tpu_torch.updaters.updater import pack_state
    kernel, st = "apply_pairs", pack_state(st)
getattr(pair_sweep, kernel)(st, torch.from_numpy(uids).cuda(), pay, p)
torch.cuda.synchronize()
"""


@pytest.mark.parametrize("kernel", ["apply_pairs", "apply_pairs2",
                                    "apply_rowmajor"])
def test_cuda_apply_refuses_an_unsorted_stream(card, kernel):
    """Every apply design sums runs of consecutive equal ids, so a
    non-decreasing stream is asserted on the device: by the wrappers of
    the planar kernels, by the row-major kernel itself. The assert ends
    the process's CUDA context, hence the subprocess."""
    here = pathlib.Path(__file__).resolve().parent
    r = subprocess.run(
        [sys.executable, "-c", _UNSORTED_PAIRS, kernel], cwd=here.parent,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(here.parent), str(here)])},
    )
    out = r.stdout + r.stderr
    assert r.returncode != 0, out
    assert "device-side assert" in out or "non-decreasing" in out, out


@pytest.mark.parametrize("K", [0, 4, 96])
def test_cuda_pull_packed_matches_plain_and_pull_pairs(card, K):
    rng = np.random.default_rng(90 + K)
    p = port_params(V_dim=K)
    st = state_from_numpy(state_np(K, rng), device=card)
    a, _ = packed_probe.pack_state(st)
    uids = torch.from_numpy(sorted_uids(rng)[0]).to(card)
    n0 = cuda.LAUNCHES["pull_packed"]
    got = packed_probe.pull_packed(a, uids, p)
    assert cuda.LAUNCHES["pull_packed"] == n0 + 1
    # a gather with a mask: exact
    assert torch.equal(got, packed_probe.pull_packed_plain(a, uids, p))
    assert torch.equal(got, pair_sweep.pull_pairs(st, uids, p))
    assert torch.equal(packed_probe.pull_packed(a, uids[:0], p),
                       torch.empty((1 + K, 0), device=card))


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (2, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2)])
@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("design", ["lanes", "tiles"])
def test_cuda_apply_packed_matches_plain_and_apply_pairs(card, K, wupd, vupd,
                                                         tff, repeat, design):
    rng = np.random.default_rng(95 + K)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng)
    uids, valid = sorted_uids(rng, repeat=repeat)
    pay = torch.from_numpy(payload(K, valid, rng)).to(card)
    uids = torch.from_numpy(uids).to(card)
    a, b = packed_probe.pack_state(state_from_numpy(s, card))
    n0 = cuda.LAUNCHES["apply_packed"]
    a2, b2 = packed_probe.apply_packed(a.clone(), b.clone(), uids, pay, p,
                                       design)
    assert cuda.LAUNCHES["apply_packed"] == n0 + 1
    got = packed_probe.unpack_state(a2, b2)
    ref = packed_probe.unpack_state(*packed_probe.apply_packed_plain(
        a.clone(), b.clone(), uids, pay, p))
    cur = pair_sweep.apply_pairs(state_from_numpy(s, card), uids, pay, p)
    for name in LEAVES:
        # 1 ulp against the plain version (its scalar division), the same
        # bits as the unpacked kernel (the same arithmetic)
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6, msg=name)
        assert torch.equal(getattr(got, name), getattr(cur, name)), name


def bisect_stream(rng, n=N, u=700, hot=90, pad=40):
    """Sorted slot ids with repeats, one hot id and a sentinel tail, and a
    payload [8, nnz] (floats, and integers in [1, 8])."""
    ids = np.sort(np.r_[rng.integers(0, n, u), np.full(hot, n // 3)])
    sid = np.r_[ids, np.full(pad, n)].astype(np.int32)
    pay = rng.normal(size=(8, sid.shape[0])).astype(np.float32)
    ipay = rng.integers(1, 9, size=pay.shape).astype(np.float32)
    return sid, pay, ipay


@pytest.mark.parametrize("block_rows", [1024, 256, 1000])
def test_cuda_bisect_w_matches_plain(card, block_rows):
    rng = np.random.default_rng(100)
    sid, pay, ipay = (torch.from_numpy(a).to(card) for a in bisect_stream(rng))
    w = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(card)
    n0 = cuda.LAUNCHES["bisect_w"]
    got = bisect_probe.bisect_w(sid, pay, w, block_rows=block_rows)
    assert cuda.LAUNCHES["bisect_w"] == n0 + 1
    # runs of up to ~90 slots summed in slot order, the plain version's
    # index_add_ in another: a few ulp of the sum
    torch.testing.assert_close(got, bisect_probe.bisect_w_plain(sid, pay, w),
                               rtol=1e-5, atol=1e-5)
    iw = torch.round(w * 4)
    assert torch.equal(bisect_probe.bisect_w(sid, ipay, iw,
                                             block_rows=block_rows),
                       bisect_probe.bisect_w_plain(sid, ipay, iw))
    for variant in ("scanonly", "loadonly"):
        assert torch.equal(bisect_probe.bisect_w(sid, pay, w, variant,
                                                 block_rows), w)
    # the first design (a search per table row) sums each run in the same
    # slot order: the same bits, under its own launch count
    n0, r0 = cuda.LAUNCHES["bisect_w"], cuda.LAUNCHES["bisect_rowscan"]
    scan = bisect_probe.bisect_w(sid, pay, w, "rowscan", block_rows)
    assert (cuda.LAUNCHES["bisect_w"], cuda.LAUNCHES["bisect_rowscan"]) == (
        n0, r0 + 1)
    assert torch.equal(scan, got)
    assert torch.equal(bisect_probe.bisect_w(sid, pay, w,
                                             block_rows=block_rows), got)
    # an empty stream adds nothing
    assert torch.equal(bisect_probe.bisect_w(sid[:0], pay[:, :0].contiguous(),
                                             w, block_rows=block_rows), w)


@pytest.mark.parametrize("n,u,hot,block_rows", [(4096, 700, 90, 1024),
                                                (5000, 3000, 600, 1000),
                                                (1 << 17, 20000, 5, 1024),
                                                (1030, 1, 0, 1024),
                                                (64, 5000, 300, 16)])
def test_cuda_bisect_w_sparse_sizes(card, n, u, hot, block_rows):
    """The sparse design at other sizes: a table that is no multiple of
    the block (a ragged last block, the scalar copy), streams long enough
    for several rounds of the slice search, a run longer than a block's
    threads, one slot, blocks of 16 rows. Against the float64 sums within
    the float32 summation bound, exact on integers, the bits of the row
    scan; an unaligned ``w`` takes the scalar copy."""
    rng = np.random.default_rng(102)
    sid, pay, ipay = (torch.from_numpy(a).to(card)
                      for a in bisect_stream(rng, n=n, u=u, hot=hot))
    w = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(card)
    got = bisect_probe.bisect_w(sid, pay, w, block_rows=block_rows)
    ref = w.double() + bisect_probe.row_sums(sid, pay[:1].double(), n)[0]
    seg = bisect_probe.row_sums(sid, torch.ones_like(pay[:1]).double(), n)[0]
    tol = seg * 2.0 ** -24 * (w.abs().double() + bisect_probe.row_sums(
        sid, pay[:1].abs().double(), n)[0])
    assert bool(((got.double() - ref).abs() <= tol).all())
    assert torch.equal(got, bisect_probe.bisect_w(sid, pay, w, "rowscan",
                                                  block_rows))
    iw = torch.round(w * 4)
    assert torch.equal(bisect_probe.bisect_w(sid, ipay, iw,
                                             block_rows=block_rows),
                       bisect_probe.bisect_w_plain(sid, ipay, iw))
    for variant in ("scanonly", "loadonly"):
        assert torch.equal(bisect_probe.bisect_w(sid, pay, w, variant,
                                                 block_rows), w)
    odd = torch.cat([w[:1], w])[1:]  # the same floats, 4 bytes off
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    assert torch.equal(bisect_probe.bisect_w(sid, pay, odd,
                                             block_rows=block_rows), got)


@pytest.mark.parametrize("inplace", [False, True])
def test_cuda_bisect_ftrl4_matches_plain(card, inplace):
    rng = np.random.default_rng(101)
    sid, pay, ipay = (torch.from_numpy(a).to(card) for a in bisect_stream(rng))
    s = state_np(0, rng)
    leaves = [torch.from_numpy(s[k]).to(card) for k in ("w", "z", "n", "cnt")]
    n0 = cuda.LAUNCHES["bisect_ftrl4"]
    mine = [t.clone() for t in leaves]
    got = bisect_probe.bisect_ftrl4(sid, pay, *mine, inplace=inplace)
    assert cuda.LAUNCHES["bisect_ftrl4"] == n0 + 1
    ref = bisect_probe.bisect_ftrl4_plain(sid, pay, *leaves)
    for x, y, mine_t, orig in zip(got, ref, mine, leaves):
        # sums in another order than index_add_, and the plain version's
        # scalar division as a reciprocal multiply: a few ulp
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        assert (x is mine_t) == inplace
        if not inplace:
            assert torch.equal(mine_t, orig)  # inputs untouched
    # an integer payload on a zero state: the sums, hence n = g^2 and the
    # count, are exact
    zero = [torch.zeros(N, device=card) for _ in range(4)]
    got = bisect_probe.bisect_ftrl4(sid, ipay, *zero)
    ref = bisect_probe.bisect_ftrl4_plain(sid, ipay, *zero)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    assert bool((got[3] > 0).any())


@pytest.mark.parametrize("nslots,rows", [(0, 8), (100, 8), (5000, 64),
                                         (40000, 3)])
def test_cuda_slot_accum_matches_plain(card, nslots, rows):
    """From no slot to hot rows that span ~100 of the 128-slot chunks
    (40000 slots into 3 rows); one row in the middle gets no slot."""
    rng = np.random.default_rng(110 + rows)
    ids = np.sort(rng.integers(0, rows, nslots)).astype(np.int32)
    ids[ids == 1] = 2
    sid = torch.from_numpy(ids).to(card)
    pay = torch.from_numpy(rng.normal(size=(nslots, 128)).astype(np.float32)
                           ).to(card)
    n0 = cuda.LAUNCHES["slot_accum"]
    got = slot_probe.slot_accum(sid, pay, rows)
    assert cuda.LAUNCHES["slot_accum"] == n0 + 1
    # against the float64 sums: any float32 order is within
    # (n-1) * 2^-24 * sum|x| over a row of n slots
    ref = slot_probe.slot_accum_plain(sid, pay.double(), rows)
    seg_n = torch.bincount(sid.long(), minlength=rows).double()[:, None]
    tol = ((seg_n - 1).clamp(min=0) * 2.0 ** -24
           * slot_probe.slot_accum_plain(sid, pay.abs().double(), rows))
    assert bool(((got.double() - ref).abs() <= tol).all())
    assert bool((got[1] == 0).all())
    ipay = torch.from_numpy(rng.integers(1, 9, size=(nslots, 128)).astype(
        np.float32)).to(card)
    assert torch.equal(slot_probe.slot_accum(sid, ipay, rows),
                       slot_probe.slot_accum_plain(sid, ipay, rows))
    again = slot_probe.slot_accum(sid, pay, rows)
    assert torch.equal(got, again)  # no atomics: the same bits every time


# ---------------------------------------------------------------------------
# the pull and apply over the row-major table (layout=packed,
# csrc/rowmajor_pairs.cu)
# ---------------------------------------------------------------------------


def lanes(rng, n, u, n_valid, repeat=False):
    """``u`` lanes of sorted ids of [0, n), the first ``n_valid`` real
    (unique, or with runs of equal ids), the rest the sentinel ``n``."""
    if repeat and n_valid:
        raw = np.sort(rng.choice(n, size=max(n_valid // 3, 1)))
        raw = np.sort(np.concatenate([raw, raw[::2], raw[::5], raw]))[:n_valid]
        n_valid = raw.shape[0]
    else:
        raw = np.sort(rng.choice(n, size=n_valid, replace=False))
    uids = np.full(u, n, np.int32)
    uids[:n_valid] = raw
    return uids, np.arange(u) < n_valid


def lane_payload(K, valid, rng):
    u = valid.shape[0]
    vf = valid.astype(np.float32)
    grads = rng.normal(size=(1 + K, u)).astype(np.float32) * valid
    addc = rng.integers(1, 4, u).astype(np.float32) * vf
    return np.concatenate([grads, addc[None], vf[None]], axis=0)


@pytest.mark.parametrize("K", [0, 1, 3, 4, 6, 16, 40, 96, 100])
@pytest.mark.parametrize("u,n_valid", [(384, 336), (1, 1), (70, 0),
                                       (1000, 999)])
def test_cuda_pull_rowmajor_matches_plain_and_pull_pairs(card, K, u, n_valid):
    """K odd (1-float pieces), K % 4 == 2 (2-float pieces), K = 0 (the
    head alone), K = 100 (a shared-memory tile past the 48 KB a kernel
    gets unasked), lane counts that fill no warp, one lane, all lanes
    sentinel: a gather with a mask, so exact, and equal to the planar
    kernel on the unpacked state, at every piece width."""
    rng = np.random.default_rng(120 + K)
    p = port_params(V_dim=K)
    st = state_from_numpy(state_np(K, rng), device=card)
    tb = pack_state(st)
    uids = torch.from_numpy(lanes(rng, N, u, n_valid)[0]).to(card)
    n0 = cuda.LAUNCHES["pull_rowmajor"]
    got = pair_sweep.pull_pairs(tb, uids, p)
    assert cuda.LAUNCHES["pull_rowmajor"] == n0 + 1
    assert got.shape == (1 + K, u)
    assert torch.equal(got, pair_sweep.pull_pairs_plain(tb, uids, p))
    assert torch.equal(got, pair_sweep.pull_pairs(st, uids, p))
    for vec in (1, 2, 4):
        assert torch.equal(got, pair_sweep._pull_rowmajor(tb, uids, p, vec))
    assert torch.equal(pair_sweep.pull_pairs(tb, uids[:0], p),
                       torch.empty((1 + K, 0), device=card))


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (2, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2),
                                             (16, "ftrl", "adagrad", 0),
                                             (5, "ftrl", "sgd", 1),
                                             (96, "ftrl", "adagrad", 0),
                                             (100, "ftrl", "adagrad", 0)])
@pytest.mark.parametrize("u,n_valid,repeat", [(384, 336, False),
                                              (384, 336, True),
                                              (1, 1, False), (70, 0, False),
                                              (1000, 999, True)])
def test_cuda_apply_rowmajor_matches_plain_and_apply_pairs(card, K, wupd,
                                                           vupd, tff, u,
                                                           n_valid, repeat):
    """Against its plain version (1 ulp: the plain version's division by
    a scalar runs as a multiply by the reciprocal on the card) and, bit
    for bit, against the planar kernel after ``unpack_state``, at every
    piece width; rows no lane names keep their bits; a second call on the
    same inputs gives the same bits (no atomics)."""
    rng = np.random.default_rng(130 + K)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng)
    uids_np, valid = lanes(rng, N, u, n_valid, repeat)
    pay = torch.from_numpy(lane_payload(K, valid, rng)).to(card)
    uids = torch.from_numpy(uids_np).to(card)
    tb = pack_state(state_from_numpy(s, card))
    n0 = cuda.LAUNCHES["apply_rowmajor"]
    out = pair_sweep.apply_pairs(tb, uids, pay, p)
    assert out is tb and cuda.LAUNCHES["apply_rowmajor"] == n0 + 1
    a = unpack_state(out)
    b = unpack_state(pair_sweep.apply_pairs_plain(
        pack_state(state_from_numpy(s, card)), uids, pay, p))
    c = pair_sweep.apply_pairs(state_from_numpy(s, card), uids, pay, p)
    again = pair_sweep.apply_pairs(pack_state(state_from_numpy(s, card)),
                                   uids, pay, p)
    assert torch.equal(again.tbl, out.tbl)
    for vec in (1, 2, 4):
        narrow = pair_sweep._apply_rowmajor(
            pack_state(state_from_numpy(s, card)), uids, pay, p, vec)
        assert torch.equal(narrow.tbl, out.tbl), vec
    touched = torch.zeros(N, dtype=torch.bool, device=card)
    touched[uids[torch.from_numpy(valid).to(card)].long()] = True
    for name in LEAVES:
        x = getattr(a, name)
        torch.testing.assert_close(x, getattr(b, name), rtol=1e-5, atol=1e-6,
                                   msg=name)
        assert torch.equal(x, getattr(c, name)), name
        orig = torch.from_numpy(s[name]).to(card)
        assert torch.equal(x[..., ~touched], orig[..., ~touched]), name


def test_cuda_apply_rowmajor_runs_across_warps(card):
    """Runs of equal ids that start in one warp's 32 lanes and end in the
    next one's, and a run longer than a warp: the lane that starts the run
    owns all of it. An integer payload through SGD with unit rates on a
    zero table sums exactly, so a lane lost or added twice fails."""
    K = 4
    p = port_params(V_dim=K, w_updater="sgd", V_updater="sgd", V_threshold=0,
                    lr_eta=1.0, l2=0.0, V_lr_eta=1.0, V_l2=0.0, l1=0.0)
    ids = np.concatenate([np.arange(30), np.full(5, 100),     # lanes 30..34
                          np.arange(200, 225), np.full(70, 300),  # 60..129
                          np.arange(400, 420)]).astype(np.int32)
    u = ids.shape[0]
    rng = np.random.default_rng(140)
    pay = rng.integers(1, 9, (3 + K, u)).astype(np.float32)
    zero = {k: np.zeros_like(v) for k, v in state_np(K, rng).items()}
    uids, pay_t = torch.from_numpy(ids).to(card), torch.from_numpy(pay).to(card)
    out = unpack_state(pair_sweep.apply_pairs(
        pack_state(state_from_numpy(zero, card)), uids, pay_t, p))
    ref = pair_sweep.apply_pairs_plain(state_from_numpy(zero, card), uids,
                                       pay_t, p)
    sums = np.zeros((3 + K, N), np.float64)
    np.add.at(sums.T, ids, pay.T.astype(np.float64))
    for name in LEAVES:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    np.testing.assert_array_equal(out.w.cpu().numpy(), -sums[0])
    np.testing.assert_array_equal(out.V.cpu().numpy(), -sums[1:1 + K])
    np.testing.assert_array_equal(out.cnt.cpu().numpy(), sums[1 + K])


def test_cuda_planar_only_kernels_refuse_a_packed_state(card):
    """``apply_pairs2`` is planar only; every row-major wrapper checks its
    table's shape and contiguity."""
    rng = np.random.default_rng(150)
    p = port_params(V_dim=2)
    tb = pack_state(state_from_numpy(state_np(2, rng), device=card))
    uids_np, valid = sorted_uids(rng)
    uids = torch.from_numpy(uids_np).to(card)
    pay = torch.from_numpy(payload(2, valid, rng)).to(card)
    with pytest.raises(TypeError, match="layout=packed"):
        pair_sweep.apply_pairs2(tb, uids, pay, p)
    with pytest.raises(ValueError, match="offsets has shape"):
        sweep_ms.sweep_pull_ms(tb, uids, uids[:9], p, block_rows=512)
    bad = pack_state(state_from_numpy(state_np(2, rng), device=card))
    bad.tbl = bad.tbl[:, :-1]  # not [N, 4+2K], not contiguous
    off = sweep.offsets_1(uids, N, 512)
    with pytest.raises(ValueError):
        pair_sweep.pull_pairs(bad, uids, p)
    with pytest.raises(ValueError):
        sweep_ms.sweep_pull_ms(bad, uids, off, p, block_rows=512)
    with pytest.raises(ValueError):
        sweep_ms.sweep_apply_ms(bad, uids, pay, off, p, block_rows=512)


@pytest.mark.parametrize("K", [129, 156, 258, 440, 455, 640])
@pytest.mark.parametrize("kernel", ["pull", "apply", "sweep_pull",
                                    "sweep_apply"])
def test_cuda_rowmajor_kernels_at_wide_k(card, kernel, K):
    """The widths past one tile, which take the factors in chunks of 128:
    129 and 258 (a last chunk of 1 and 2 factors, with 1- and 2-float
    pieces), 156 (libffm Criteo, 39 fields x 4), 440 and 455 (where a
    whole [1+K] pull tile and a whole [K] apply tile pass the card's
    227 KB), 640 (an FFM of 40 slot fields x 16). Each row-major kernel
    launches and is bit-equal to its planar kernel; an apply leaves the
    rows no lane names as they were."""
    rng = np.random.default_rng(200 + K)
    p = port_params(V_dim=K, V_threshold=1)
    sweep_kernel = kernel.startswith("sweep")
    n = N2 if sweep_kernel else N
    s = state_np(K, rng, n=n)
    tb = pack_state(state_from_numpy(s, card))
    st = state_from_numpy(s, card)
    if sweep_kernel:
        sid, off = (torch.from_numpy(a).to(card)
                    for a in id_streams(rng, (300, 200)))
        pay = torch.from_numpy(slot_payload(K, sid.shape[0], rng)).to(card)
        named = sid[sid < n]
    else:
        uids_np, valid = lanes(rng, n, 1000, 999, repeat=kernel == "apply")
        uids = torch.from_numpy(uids_np).to(card)
        pay = torch.from_numpy(lane_payload(K, valid, rng)).to(card)
        named = uids[torch.from_numpy(valid).to(card)]
    name = {"pull": "pull_rowmajor", "apply": "apply_rowmajor",
            "sweep_pull": "sweep_pull_rowmajor",
            "sweep_apply": "sweep_apply_rowmajor"}[kernel]
    n0 = cuda.LAUNCHES[name]
    if kernel == "pull":
        got = pair_sweep.pull_pairs(tb, uids, p)
        assert torch.equal(got, pair_sweep.pull_pairs(st, uids, p))
        assert torch.equal(got, pair_sweep.pull_pairs_plain(tb, uids, p))
    elif kernel == "sweep_pull":
        got = sweep_ms.sweep_pull_ms(tb, sid, off, p, block_rows=R2)
        assert torch.equal(got, sweep_ms.sweep_pull_ms(st, sid, off, p,
                                                       block_rows=R2))
        assert torch.equal(got, sweep_ms.sweep_pull_ms_plain(
            tb, sid, off, p, block_rows=R2))
    else:
        if kernel == "apply":
            a = unpack_state(pair_sweep.apply_pairs(tb, uids, pay, p))
            b = pair_sweep.apply_pairs(st, uids, pay, p)
        else:
            a = unpack_state(sweep_ms.sweep_apply_ms(tb, sid, pay, off, p,
                                                     block_rows=R2))
            b = sweep_ms.sweep_apply_ms(st, sid, pay, off, p, block_rows=R2)
        touched = torch.zeros(n, dtype=torch.bool, device=card)
        touched[named.long()] = True
        for leaf in LEAVES:
            x = getattr(a, leaf)
            assert torch.equal(x, getattr(b, leaf)), leaf
            orig = torch.from_numpy(s[leaf]).to(card)
            assert torch.equal(x[..., ~touched], orig[..., ~touched]), leaf
        assert not torch.equal(a.V, torch.from_numpy(s["V"]).to(card))
    assert cuda.LAUNCHES[name] == n0 + 1


# ---------------------------------------------------------------------------
# the sweep pull and apply over the row-major table (layout=packed,
# csrc/rowmajor_sweep.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [0, 1, 3, 4, 6, 16, 40, 96, 100])
@pytest.mark.parametrize("lens", [(300,), (300, 200), (40, 300, 5)])
def test_cuda_sweep_pull_rowmajor_matches_plain_and_sweep_pull(card, K, lens):
    """One, two and three streams with ids repeated within and across
    them, K odd (1-float pieces), K % 4 == 2 (2-float pieces), K = 0 (the
    head alone), K = 100 (a tile past 48 KB): a gather with a mask, so
    exact against the plain version and against the planar kernel, at
    every piece width; sentinel slots are 0."""
    rng = np.random.default_rng(160 + K + len(lens))
    p = port_params(V_dim=K)
    st = state_from_numpy(state_np(K, rng, n=N2), device=card)
    tb = pack_state(st)
    sid, off = (torch.from_numpy(a).to(card) for a in id_streams(rng, lens))
    n0 = cuda.LAUNCHES["sweep_pull_rowmajor"]
    got = sweep_ms.sweep_pull_ms(tb, sid, off, p, block_rows=R2)
    assert cuda.LAUNCHES["sweep_pull_rowmajor"] == n0 + 1
    assert got.shape == (1 + K, sid.shape[0])
    assert torch.equal(got, sweep_ms.sweep_pull_ms_plain(tb, sid, off, p,
                                                         block_rows=R2))
    assert torch.equal(got, sweep_ms.sweep_pull_ms(st, sid, off, p,
                                                   block_rows=R2))
    for vec in (1, 2, 4):
        assert torch.equal(got, sweep_ms._sweep_pull_rowmajor(
            tb, sid, off, p, R2, vec))
    assert bool((got[:, sid == N2] == 0).all())


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (2, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2),
                                             (16, "ftrl", "adagrad", 0),
                                             (5, "ftrl", "sgd", 1),
                                             (96, "ftrl", "adagrad", 0),
                                             (100, "ftrl", "adagrad", 0)])
@pytest.mark.parametrize("lens", [(300,), (300, 200), (40, 300, 5)])
def test_cuda_sweep_apply_rowmajor_matches_plain_and_sweep_apply(
        card, K, wupd, vupd, tff, lens):
    """Against its plain version (slot sums in another order than
    index_add_'s atomics and the plain version's division as a reciprocal
    multiply: a few ulp) and, bit for bit, against the planar sweep apply
    after ``unpack_state``, at every piece width (VEC 1, 2, 4); rows no
    slot names keep their bits; a second call on the same inputs gives
    the same bits (no atomics). A fifth of the slots carry touch 0, so
    some rows get counts and no update."""
    rng = np.random.default_rng(170 + K + len(lens))
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng, n=N2)
    sid_np, off_np = id_streams(rng, lens)
    sid, off = torch.from_numpy(sid_np).to(card), torch.from_numpy(off_np).to(card)
    pay = torch.from_numpy(slot_payload(K, sid.shape[0], rng)).to(card)
    tb = pack_state(state_from_numpy(s, card))
    n0 = cuda.LAUNCHES["sweep_apply_rowmajor"]
    out = sweep_ms.sweep_apply_ms(tb, sid, pay, off, p, block_rows=R2)
    assert out is tb and cuda.LAUNCHES["sweep_apply_rowmajor"] == n0 + 1
    a = unpack_state(out)
    b = unpack_state(sweep_ms.sweep_apply_ms_plain(
        pack_state(state_from_numpy(s, card)), sid, pay, off, p,
        block_rows=R2))
    c = sweep_ms.sweep_apply_ms(state_from_numpy(s, card), sid, pay, off, p,
                                block_rows=R2)
    again = sweep_ms.sweep_apply_ms(pack_state(state_from_numpy(s, card)),
                                    sid, pay, off, p, block_rows=R2)
    assert torch.equal(again.tbl, out.tbl)
    for vec in (1, 2, 4):
        narrow = sweep_ms._sweep_apply_rowmajor(
            pack_state(state_from_numpy(s, card)), sid, pay, off, p, R2, vec)
        assert torch.equal(narrow.tbl, out.tbl), vec
    named = torch.zeros(N2, dtype=torch.bool, device=card)
    named[sid[sid < N2].long()] = True
    for name in LEAVES:
        x = getattr(a, name)
        torch.testing.assert_close(x, getattr(b, name), rtol=1e-5, atol=1e-6,
                                   msg=name)
        assert torch.equal(x, getattr(c, name)), name
        orig = torch.from_numpy(s[name]).to(card)
        assert torch.equal(x[..., ~named], orig[..., ~named]), name


@pytest.mark.parametrize("lens", [(300,), (300, 200)])
def test_cuda_sweep_apply_rowmajor_exact_on_integers(card, lens):
    """Integer payload in [1, 8] through SGD with unit rates on a zero
    table: w = -sum(gw), V = -sum(gV), cnt = sum(add_cnt), all exact in
    float32, so a slot lost or added twice fails; runs of equal ids cross
    the 32-slot windows of the warps."""
    rng = np.random.default_rng(180)
    K = 5
    p = port_params(V_dim=K, w_updater="sgd", V_updater="sgd", lr_eta=1.0,
                    l2=0.0, V_lr_eta=1.0, V_l2=0.0, V_threshold=0)
    s = {k: np.zeros_like(v) for k, v in state_np(K, rng, n=N2).items()}
    sid_np, off_np = id_streams(rng, lens)
    pay_np = slot_payload(K, sid_np.shape[0], rng, integer=True)
    sid, off, pay = (torch.from_numpy(a).to(card)
                     for a in (sid_np, off_np, pay_np))
    a = unpack_state(sweep_ms.sweep_apply_ms(
        pack_state(state_from_numpy(s, card)), sid, pay, off, p,
        block_rows=R2))
    real = sid_np < N2
    sums = np.zeros((3 + K, N2), np.float64)
    np.add.at(sums.T, sid_np[real], pay_np.T[real].astype(np.float64))
    np.testing.assert_array_equal(a.w.cpu().numpy(), -sums[0])
    np.testing.assert_array_equal(a.V.cpu().numpy(), -sums[1:1 + K])
    np.testing.assert_array_equal(a.cnt.cpu().numpy(), sums[1 + K])


def test_cuda_sweep_rowmajor_dense_block(card):
    """Most rows of one table block named, every other block empty."""
    rng = np.random.default_rng(190)
    K = 4
    p = port_params(V_dim=K, V_threshold=0)
    s = state_np(K, rng, n=N2)
    ids = np.sort(rng.choice(R2, size=450, replace=False)) + R2
    sid = torch.from_numpy(np.r_[ids, np.full(30, N2)].astype(np.int32)
                           ).to(card)
    off = sweep.offsets_1(sid, N2, R2)
    pay = torch.from_numpy(slot_payload(K, sid.shape[0], rng)).to(card)
    st, tb = state_from_numpy(s, card), pack_state(state_from_numpy(s, card))
    assert torch.equal(sweep_ms.sweep_pull_ms(tb, sid, off, p, block_rows=R2),
                       sweep_ms.sweep_pull_ms(st, sid, off, p, block_rows=R2))
    a = unpack_state(sweep_ms.sweep_apply_ms(tb, sid, pay, off, p,
                                             block_rows=R2))
    b = sweep_ms.sweep_apply_ms(st, sid, pay, off, p, block_rows=R2)
    for name in LEAVES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("kernel", ["pull", "apply"])
def test_cuda_sweep_rowmajor_traps_on_an_unsorted_stream(card, kernel):
    """The row-major sweep kernels check the order themselves, each slot
    against its left neighbour: a descent inside a stream's covered range
    fails a device-side assert (hence the subprocess)."""
    here = pathlib.Path(__file__).resolve().parent
    r = subprocess.run(
        [sys.executable, "-c", _UNSORTED, kernel, "packed"], cwd=here.parent,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(here.parent), str(here)])},
    )
    out = r.stdout + r.stderr
    assert r.returncode != 0, out
    assert "device-side assert" in out or "must be sorted" in out, out


# ---------------------------------------------------------------------------
# the segment sum's designs (csrc/segsum_tiles.cu, csrc/segsum.cu)
# ---------------------------------------------------------------------------


def _segsum_designs(pay_t, lanes_t, ub):
    rows = pay_t.T.contiguous()
    return {
        "tiles": lambda: segsum.segsum_sorted(pay_t, lanes_t, ub),
        "chunks": lambda: segsum.segsum_sorted_chunks(pay_t, lanes_t, ub),
        "rows": lambda: segsum.segsum_sorted_rows(rows, lanes_t, ub),
    }


@pytest.mark.parametrize("design", ["tiles", "chunks", "rows"])
@pytest.mark.parametrize("bl,ub,pp,pad", [(20000, 4096, 18, True),
                                          (200000, 4096, 18, True),
                                          (5001, 640, 7, False),
                                          (100, 64, 3, False),
                                          (1, 8, 1, False),
                                          (4099, 300, 40, True),
                                          (20000, 4096, 97, True),
                                          (20000, 640, 300, True)])
def test_cuda_segsum_designs(card, design, bl, ub, pp, pad):
    """Every design, on a power-law lane stream whose hot lane spans
    hundreds of tiles, on streams that are no multiple of a tile (or of
    4: the scalar loads), one slot, 40 payload rows, and 300 (more than
    the second pass's block has threads, which the row-major design
    refuses): within the
    float32 summation bound of the float64 sums, exact on an integer
    payload, untouched lanes exactly 0, the same bits on a second run,
    and each under its own launch count."""
    rng = np.random.default_rng(200 + bl)
    raw = np.sort(np.minimum(rng.zipf(1.3, bl) - 1, min(3000, ub - 2)))
    raw[raw == 1] = 2                       # a lane in the middle untouched
    raw = raw.astype(np.int32)
    inv = segsum.pad_sorted_stream(raw) if pad else raw
    pay = rng.normal(size=(pp, inv.shape[0])).astype(np.float32)
    ipay = rng.integers(1, 9, size=pay.shape).astype(np.float32)
    pay[:, bl:] = 0.0
    ipay[:, bl:] = 0.0
    lanes_t = torch.from_numpy(inv).to(card)
    pay_t, ipay_t = torch.from_numpy(pay).to(card), torch.from_numpy(ipay).to(card)
    counter = {"tiles": "segsum_sorted", "chunks": "segsum_chunks",
               "rows": "segsum_rows"}[design]
    if design == "rows" and pp > segsum.ROWS_MAX_COLS:
        with pytest.raises(ValueError, match="at most"):
            _segsum_designs(pay_t, lanes_t, ub)[design]()
        return
    n0 = cuda.LAUNCHES[counter]
    got = _segsum_designs(pay_t, lanes_t, ub)[design]()
    assert cuda.LAUNCHES[counter] == n0 + 1
    assert got.shape == (pp, ub)
    ref = segsum.segsum_sorted_plain(pay_t.double(), lanes_t, ub)
    seg_n = torch.bincount(lanes_t.long(), minlength=ub).double()
    abs_sum = segsum.segsum_sorted_plain(pay_t.abs().double(), lanes_t, ub)
    tol = (seg_n - 1).clamp(min=0) * 2.0 ** -24 * abs_sum
    assert bool(((got.double() - ref).abs() <= tol).all())
    assert bool((got[:, seg_n == 0] == 0).all()) and bool((seg_n == 0).any())
    assert torch.equal(_segsum_designs(pay_t, lanes_t, ub)[design](), got)
    assert torch.equal(_segsum_designs(ipay_t, lanes_t, ub)[design](),
                       segsum.segsum_sorted_plain(ipay_t, lanes_t, ub))


def test_cuda_segsum_unaligned_payload(card):
    """A payload 4 bytes off a 16-byte boundary takes the scalar loads."""
    rng = np.random.default_rng(210)
    bl, ub, pp = 4096, 512, 6
    lanes_t = torch.from_numpy(np.sort(rng.integers(0, ub, bl)).astype(
        np.int32)).to(card)
    flat = torch.from_numpy(rng.integers(1, 9, pp * bl + 1).astype(
        np.float32)).to(card)
    odd = flat[1:].view(pp, bl)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    assert torch.equal(segsum.segsum_sorted(odd, lanes_t, ub),
                       segsum.segsum_sorted_plain(odd, lanes_t, ub))


def test_cuda_pull_packed_readonly_issues_the_loads_and_stores_nothing(card):
    """The packed pull's floor: one launch under the pull's count, no
    output, A as it was."""
    rng = np.random.default_rng(95)
    p = port_params(V_dim=96)
    a, _ = packed_probe.pack_state(state_from_numpy(state_np(96, rng),
                                                    device=card))
    before = a.clone()
    uids = torch.from_numpy(sorted_uids(rng)[0]).to(card)
    n0 = cuda.LAUNCHES["pull_packed"]
    assert packed_probe.pull_packed(a, uids, p, "readonly") is None
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["pull_packed"] == n0 + 1
    assert torch.equal(a, before)


@pytest.mark.parametrize("extra", [
    (), (("layout", "planar"),), (("segsum", "scatter"),),
    (("kernel", "pallas"),), (("kernel", "pallas"), ("layout", "planar"),
                              ("segsum", "sorted")),
    (("ffm_block_size", "5"),)])
@pytest.mark.parametrize("L,k", [(8, 2), (24, 4)])
def test_cuda_ffm_store_steps_match_cpu(card, extra, L, k):
    """loss=ffm train and eval steps on the card, every table path (K = 16
    and the config-5 width K = 96, 97 payload rows), against the same
    steps on the CPU from one state: leaves atol 2e-5 rtol 1e-5 (sums in
    another order), margins likewise."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.batch_iter import Batch
    from difacto_tpu_torch.data.prep import prep_batch
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater

    cfg = Config.from_kwargs([
        ("batch_size", "256"), ("num_bits", "14"), ("loss", "ffm"),
        ("max_nnz_per_row", str(L)), ("V_dim", str(k)), ("lr_eta", "0.1"),
        ("l1", "0.1"), ("V_lr_eta", "0.05"), ("V_threshold", "1"), *extra])
    upd = FMUpdater(cfg.effective_model_param())
    gpu = LocalStore(upd, cfg, device=card)
    cpu = LocalStore(upd, cfg, device="cpu")
    sg = gpu.init_state(5)
    sc = cpu.place_state(sg)
    rng = np.random.default_rng(300 + L)
    n = 1 << 14
    for _ in range(4):
        ids = rng.integers(0, n, (256, L)).astype(np.int32)
        ids[rng.random((256, L)) < 0.1] = -1
        vals = np.where(ids < 0, 0, rng.normal(size=(256, L))).astype(
            np.float32)
        b = Batch(ids, vals, (rng.random(256) > 0.5).astype(np.float32),
                  np.ones(256, np.float32))
        sg, _ = gpu.train_step_prepped(sg, prep_batch(b, n))
        sc, _ = cpu.train_step_prepped(sc, prep_batch(b, n))
    for name in LEAVES:
        torch.testing.assert_close(getattr(sg, name).cpu(), getattr(sc, name),
                                   atol=2e-5, rtol=1e-5, msg=name)
    _, pyg = gpu.eval_step_prepped(sg, prep_batch(b, n))
    _, pyc = cpu.eval_step_prepped(sc, prep_batch(b, n))
    torch.testing.assert_close(pyg.cpu(), pyc, atol=2e-5, rtol=1e-5)


def test_cuda_host_native_engines_build_and_run(card):
    """Where the card is, the native host engines build (g++, into
    build/host_native/) and run: the parser gives the NumPy engine's
    arrays, and the prep of a batch past the 2^24-row lookup-table cap
    takes the native localizer, with NumPy's localization."""
    from difacto_tpu_torch.data import _native, libsvm, prep
    from difacto_tpu_torch.data.batch_iter import Batch

    assert _native.available(), _native.build_error()
    text = b"1 3:0.5 7:2\r\n# c\n\n0 11 5:-1e-2\n1\n"
    a, b = _native.parse_libsvm(text), libsvm.parse_libsvm_numpy(text)
    for name in ("labels", "indptr", "indices", "values"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    rng = np.random.default_rng(7)
    N = 1 << 26
    ids = rng.integers(0, N, (256, 40)).astype(np.int32)
    ids[rng.random((256, 40)) < 0.1] = -1
    n0 = _native.RUNS["localize_native"]
    pb = prep.prep_batch(Batch(ids, np.ones((256, 40), np.float32),
                               np.ones(256, np.float32),
                               np.ones(256, np.float32)), N)
    assert _native.RUNS["localize_native"] == n0 + 1
    uids, inv, counts = prep._localize_numpy(ids.reshape(-1), N)
    n_real = uids.shape[0] - 1  # the sentinel N last: there are pads
    assert uids[-1] == N and pb.uids[n_real] == N
    assert np.array_equal(pb.uids[:n_real], uids[:n_real])
    assert np.array_equal(pb.ucounts[:n_real], counts[:n_real])
    ub = pb.uids.shape[0]
    assert np.array_equal(pb.inv, np.where(inv >= n_real, ub - 1, inv))


# the XLA table path (kernel=xla: B3 the one kernel), the hot/cold split and
# device localize (host_localize=0) on the card
XLA_STEP_PATHS = [
    (("kernel", "xla"),),
    (("kernel", "xla"), ("segsum", "scatter")),
    (("kernel", "xla"), ("layout", "planar")),
    (("kernel", "xla"), ("layout", "packed"), ("segsum", "scatter")),
    (("hot_rows", "2048"),),
    (("hot_rows", "2048"), ("segsum", "scatter")),
    (("host_localize", "0"),),
    (("host_localize", "0"), ("kernel", "pallas")),
    (("host_localize", "0"), ("unique_size", "600")),
]


def xla_stores(card, extra, n_bits=14):
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater

    cfg = Config.from_kwargs([
        ("batch_size", "256"), ("num_bits", str(n_bits)),
        ("max_nnz_per_row", "12"), ("V_dim", "4"), ("lr_eta", "0.1"),
        ("l1", "0.1"), ("V_lr_eta", "0.05"), ("V_threshold", "1"), *extra])
    upd = FMUpdater(cfg.model)
    return (LocalStore(upd, cfg, device=card),
            LocalStore(upd, cfg, device="cpu"))


def zipf_batches(n_bits, count, seed, B=256, L=12):
    from difacto_tpu_torch.data.batch_iter import Batch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        ids = (rng.zipf(1.2, (B, L)) % (1 << n_bits)).astype(np.int32)
        ids[rng.random((B, L)) < 0.1] = -1
        vals = np.where(ids < 0, 0, rng.normal(size=(B, L))).astype(
            np.float32)
        out.append(Batch(ids, vals, (rng.random(B) > 0.5).astype(np.float32),
                         np.ones(B, np.float32)))
    return out


def run_steps(store, st, batches, lut=None):
    """Train steps on ``batches`` (host-prepped, split by ``lut``, or raw
    when the store localizes on the device); then an eval of the last.
    Returns (state, summed dropped ids, eval margins)."""
    from difacto_tpu_torch.data.prep import prep_batch

    n = store.num_rows
    dropped = 0.0

    def prep(b):
        return prep_batch(b, n, remap=lut, hot_rows=store.hot_rows)

    for b in batches:
        if store.cfg.data.host_localize:
            st, m = store.train_step_prepped(st, prep(b))
        else:
            st, m = store.train_step(st, b.ids, b.vals, b.labels, b.mask)
        dropped += float(m.dropped_ids)
    if store.cfg.data.host_localize:
        _, py = store.eval_step_prepped(st, prep(batches[-1]))
    else:
        b = batches[-1]
        _, py = store.eval_step(st, b.ids, b.vals, b.labels, b.mask)
    return st, dropped, py


@pytest.mark.parametrize("extra", XLA_STEP_PATHS)
def test_cuda_xla_store_steps_match_cpu(card, extra):
    """Four train steps and an eval on the card against the CPU from one
    state (canonical rows through the lut for the split): leaves atol
    2e-5 rtol 1e-5 (sums in another order; the rows where dropped ids
    alias, finite), margins likewise; B3 launched on every sorted step;
    the dropped-id counts equal."""
    from difacto_tpu_torch.data import remap
    from difacto_tpu_torch.ops.localize import localize
    from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                    state_to_numpy)

    gpu, cpu = xla_stores(card, extra)
    batches = zipf_batches(14, 4, 40)
    lut = None
    if gpu.hot_rows:
        lut = remap.build_remap(remap.count_sample(iter(batches), 1 << 14,
                                                   4), gpu.hot_rows)
        gpu.set_remap(lut)
        cpu.set_remap(lut)
    s0 = state_np(4, np.random.default_rng(41), n=1 << 14)
    sg = gpu.place_state(state_from_numpy(s0))
    sc = cpu.place_state(state_from_numpy(s0))
    n0 = cuda.LAUNCHES["segsum_sorted"]
    sg, dg, pyg = run_steps(gpu, sg, batches, lut)
    sc, dc, pyc = run_steps(cpu, sc, batches, lut)
    torch.cuda.synchronize()
    sorted_steps = gpu.sorted_grads and gpu.cfg.data.host_localize
    assert cuda.LAUNCHES["segsum_sorted"] - n0 == (4 if sorted_steps else 0)
    assert dg == dc and (dg > 0) == ("unique_size" in dict(extra))
    # an overflowing batch's dropped ids alias its last lane, whose row
    # sums them in the card's atomic order: held finite
    rest = np.ones(1 << 14, bool)
    for b in batches if not gpu.cfg.data.host_localize else ():
        loc = localize(torch.from_numpy(b.ids), 1 << 14, gpu.unique_size)
        if float(loc.overflow):
            rest[int(loc.uids[-1])] = False
    a, b = state_to_numpy(sg, lut), state_to_numpy(sc, lut)
    for name in LEAVES:
        assert np.isfinite(a[name]).all(), name
        np.testing.assert_allclose(a[name][..., rest], b[name][..., rest],
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    torch.testing.assert_close(pyg.cpu(), pyc, atol=2e-5, rtol=1e-5)


def split_step_bits(stacked, split, lut, host, b) -> None:
    """One train step of the stacked and the split table from one
    canonical state, the split fed the stacked step's per-key sums mapped
    to its lanes (canonical id -> remapped id -> lane): the pulled rows
    and the updated canonical state hold the same bits (chip_smoke.py
    keeps its own copy)."""
    from difacto_tpu_torch.data.prep import prep_batch
    from difacto_tpu_torch.data.remap import invert_remap
    from difacto_tpu_torch.learners.step import worker_grads_sorted
    from difacto_tpu_torch.ops.localize import Localized
    from difacto_tpu_torch.utils.checkpoint import state_to_numpy

    n, H = stacked.num_rows, split.hot_rows
    sa, sb = stacked.place_state(host), split.place_state(host)
    pa = stacked._placed(prep_batch(b, n), need_slots=True)
    pb = split._placed(prep_batch(b, n, remap=lut, hot_rows=H),
                       need_slots=False)
    la = Localized(pa.uids, pa.inv, pa.ucounts, pa.valid)
    lb = Localized(pb.uids, pb.inv, pb.ucounts, pb.valid)
    halves = (pb.uids_hot, pb.uids_cold)
    rows_a, raw_a = stacked._pull(sa, la)
    rows_b, raw_b = split._pull(sb, lb, halves)
    ss = pa.sorted_slots
    grads_a, _, _ = worker_grads_sorted(rows_a, la, pa.vals, pa.labels,
                                        pa.mask, (ss.x_sorted, ss.bidx,
                                                  ss.inv_sorted))
    inv_lut = torch.as_tensor(invert_remap(lut), device=pa.uids.device)
    canon = inv_lut[pb.uids.clamp(max=n - 1).long()]
    pos = torch.searchsorted(pa.uids, canon).clamp(max=pa.uids.shape[0] - 1)
    vb = pb.valid
    assert torch.equal(pa.uids[pos][vb], canon[vb])
    assert torch.equal(pa.ucounts[pos][vb], pb.ucounts[vb])
    assert torch.equal(rows_a[pos][vb].view(torch.int32),
                       rows_b[vb].view(torch.int32))
    grads_b = torch.where(vb[None, :], grads_a[:, pos], 0.0)
    sa = stacked._apply(sa, la, grads_a, raw_a)
    sb = split._apply(sb, lb, grads_b, raw_b, halves)
    a, c = state_to_numpy(sa), state_to_numpy(sb, lut)
    for name in LEAVES:
        assert np.array_equal(a[name].view(np.int32),
                              c[name].view(np.int32)), name


def test_cuda_hotcold_matches_stacked(card):
    """The split and the stacked table on the card, from one canonical
    state: one step fed the same per-key sums gives the same bits; four
    training steps on the sorted backward (B3 repeats its bits) the same
    canonical state and margins within rtol 1e-4 / atol 1e-5, the JAX
    package's tolerance for this comparison (tests/test_hotcold.py:
    149-153: B3 sums a key's slots over other tile edges when the lanes
    are renumbered)."""
    from difacto_tpu_torch.data import remap
    from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                    state_to_numpy)

    hot, _ = xla_stores(card, (("hot_rows", "2048"),))
    flat, _ = xla_stores(card, (("kernel", "xla"),))
    batches = zipf_batches(14, 4, 42)
    lut = remap.build_remap(remap.count_sample(iter(batches), 1 << 14, 4),
                            2048)
    hot.set_remap(lut)
    s0 = state_np(4, np.random.default_rng(43), n=1 << 14)
    split_step_bits(flat, hot, lut, state_from_numpy(s0), batches[0])
    sh, _, pyh = run_steps(hot, hot.place_state(state_from_numpy(s0)),
                           batches, lut)
    sf, _, pyf = run_steps(flat, flat.place_state(state_from_numpy(s0)),
                           batches)
    a, b = state_to_numpy(sh, lut), state_to_numpy(sf)
    for name in LEAVES:
        np.testing.assert_allclose(a[name], b[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    torch.testing.assert_close(pyh, pyf, atol=1e-5, rtol=1e-4)


# the LocalStore sorted paths of the compact batch cache (cache_compact)
COMPACT_PATHS = {"packed": (("layout", "packed"),),
                 "planar": (("layout", "planar"),),
                 "xla": (("kernel", "xla"),),
                 "split": (("hot_rows", "2048"),),
                 "ffm": (("loss", "ffm"), ("V_dim", "2"))}


@pytest.mark.parametrize("path", list(COMPACT_PATHS))
def test_cuda_compact_cache_matches_full(card, path):
    """cache_compact=1 against cache_compact=0 on the card, from one
    state: three steps each launch B3 on the stream derived on the card
    and end on the full form's table bit for bit; the derived stream is
    the host's, monotone with its pads on the last real lane, and B3 on
    it gives B3's bits on the host-built stream."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data import remap
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.learners.step import derive_sorted_slots
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                    state_to_numpy)
    from difacto_tpu_torch.utils.place import place_batch

    n = 1 << 14
    batches = zipf_batches(14, 3, 44)
    lut = None
    tables = []
    for compact in ("0", "1"):
        cfg = Config.from_kwargs([
            ("batch_size", "256"), ("num_bits", "14"),
            ("max_nnz_per_row", "12"), ("V_dim", "4"), ("lr_eta", "0.1"),
            ("l1", "0.1"), ("V_lr_eta", "0.05"), ("V_threshold", "1"),
            ("cache_compact", compact), *COMPACT_PATHS[path]])
        store = LocalStore(FMUpdater(cfg.effective_model_param()), cfg,
                           device=card)
        if store.hot_rows:
            lut = remap.build_remap(remap.count_sample(iter(batches), n, 3),
                                    store.hot_rows)
            store.set_remap(lut)
        st = store.place_state(state_from_numpy(state_np(
            store.param.V_dim, np.random.default_rng(45), n=n)))
        n0 = cuda.LAUNCHES["segsum_sorted"]
        for b in batches:
            pb = prep_batch(b, n, remap=lut, hot_rows=store.hot_rows)
            st, _ = store.train_step_prepped(st, pb)
            assert pb.sorted_slots.compact == (compact == "1")
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["segsum_sorted"] - n0 == len(batches)
        tables.append(state_to_numpy(st, lut))
    for name in LEAVES:
        assert np.array_equal(tables[0][name].view(np.int32),
                              tables[1][name].view(np.int32)), name
    pb = prep_batch(zipf_batches(14, 1, 46, B=250)[0], n)  # pad slots
    full = place_batch(build_sorted_slots(pb.inv, pb.vals), card)
    perm = build_sorted_slots(pb.inv, pb.vals, compact=True).slot_sorted
    derived = derive_sorted_slots(*(torch.from_numpy(a).to(card) for a in (
        pb.vals, pb.inv, perm)))
    for got, name in zip(derived, ("x_sorted", "bidx", "inv_sorted")):
        assert torch.equal(got.view(torch.int32),
                           getattr(full, name).view(torch.int32)), name
    lanes, bl = derived[2], pb.vals.size
    assert bl < lanes.shape[0]
    assert bool((lanes[1:] >= lanes[:-1]).all())
    assert bool((lanes[bl:] == lanes[bl - 1]).all())
    ub = pb.uids.shape[0]
    pay = torch.randn((5, lanes.shape[0]), device=card)
    pay[:, bl:] = 0.0
    a = segsum.segsum_sorted(pay, lanes, ub)
    b = segsum.segsum_sorted(pay, full.inv_sorted, ub)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cuda_localize_matches_host_prep(card):
    """Device localize on the card: the CPU's five arrays exactly, and
    host prep's uids, counts and inverse."""
    from difacto_tpu_torch.data.prep import prep_batch
    from difacto_tpu_torch.ops.localize import localize

    for b, U in ((zipf_batches(14, 1, 44)[0], 256 * 12),
                 (zipf_batches(14, 1, 45)[0], 700)):
        ids = torch.from_numpy(b.ids)
        got, ref = localize(ids.to(card), 1 << 14, U), localize(ids,
                                                                 1 << 14, U)
        for x, y in zip(got, ref):
            assert torch.equal(x.cpu(), y)
    b = zipf_batches(14, 1, 44)[0]
    pb = prep_batch(b, 1 << 14)
    loc = localize(torch.from_numpy(b.ids).to(card), 1 << 14, b.ids.size)
    n = int(loc.valid.sum())
    assert n == int(pb.valid.sum())
    assert np.array_equal(loc.uids.cpu().numpy()[:n], pb.uids[:n])
    assert np.array_equal(loc.counts.cpu().numpy()[:n], pb.ucounts[:n])
    real = b.ids.reshape(-1) >= 0
    assert np.array_equal(loc.inv.cpu().numpy()[real], pb.inv[real])


@pytest.mark.parametrize("layout", ["stacked", "planar", "packed"])
def test_cuda_pad_lanes_meet_inf_and_leave_the_table(card, layout):
    """B3's sums on the lanes no id fills, poisoned to Inf on the card,
    reach the XLA update: no NaN anywhere, and the rows the pad lanes
    clamp to (0, N-1), holding -0.0, keep their bits."""
    from difacto_tpu_torch.data.prep import prep_batch
    from difacto_tpu_torch.learners.step import worker_grads_sorted
    from difacto_tpu_torch.ops.localize import Localized
    from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                    state_to_numpy)

    store, _ = xla_stores(card, (("kernel", "xla"), ("layout", layout)))
    n = store.num_rows
    s0 = state_np(4, np.random.default_rng(46), n=n)
    for name in ("w", "z", "V", "nV"):
        s0[name][..., [0, n - 1]] = -0.0
    st = store.place_state(state_from_numpy(s0))
    b = zipf_batches(14, 1, 47)[0]
    b.ids[(b.ids == 0) | (b.ids == n - 1)] = 5
    pb = store._placed(prep_batch(b, n), need_slots=True)
    loc = Localized(pb.uids, pb.inv, pb.ucounts, pb.valid)
    rows_u, raw = store._pull(st, loc)
    ss = pb.sorted_slots
    grads, _, _ = worker_grads_sorted(rows_u, loc, pb.vals, pb.labels,
                                      pb.mask, (ss.x_sorted, ss.bidx,
                                                ss.inv_sorted))
    grads = torch.where(pb.valid[None, :], grads, float("inf"))
    st = store._apply(st, loc, grads, raw)
    got = state_to_numpy(st)
    for name in LEAVES:
        assert np.isfinite(got[name]).all(), name
        for row in (0, n - 1):
            assert np.array_equal(got[name][..., row].view(np.int32),
                                  s0[name][..., row].view(np.int32)), name


def _bcd_files(tmp_path, rows=3000):
    from difacto_tpu_torch.data.synthetic import make_ctr_data, write_libsvm

    for name, n, seed in (("tr", rows, 51), ("va", 800, 52)):
        write_libsvm(make_ctr_data(n, num_fields=10, vocab_per_field=200,
                                   seed=seed, w_scale=0.5, v_scale=0.05),
                     str(tmp_path / f"{name}.svm"))
    return [f"data_in={tmp_path / 'tr.svm'}", "batch_size=1024",
            "num_bits=13", "max_nnz_per_row=12", "V_dim=0", "learner=bcd",
            "l1=0.05"]


@pytest.mark.parametrize("S", [1, 4])
def test_cuda_bcd_block_step_and_run_match_cpu(card, tmp_path, S):
    """The BCD block step on the card against the CPU's from one state
    (index_add_ adds atomically on the card: rel 1e-5 / abs 1e-6), then
    a 2-epoch run: w within rtol 2e-4 / atol 2e-5, the JAX package's bound
    between shard counts, and the same train metrics."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.bcd import BCDLearner
    from difacto_tpu_torch.utils import arg_parser

    argv = _bcd_files(tmp_path) + [f"num_shards={S}", "max_num_epochs=2"]
    cfg = lambda: Config.from_kwargs(arg_parser.parse(argv))  # noqa: E731
    gpu, cpu = BCDLearner(cfg()), BCDLearner(cfg(), device="cpu")
    assert gpu.device.type == "cuda"
    rng = np.random.default_rng(53)
    for lrn in (gpu, cpu):
        lrn.reset()
    py0 = rng.normal(size=cpu.py.shape[0]).astype(np.float32)
    w0 = (rng.normal(size=cpu.num_rows) * 0.1).astype(np.float32)
    for blk in (0, 7, cpu.num_blocks - 1):
        for lrn in (gpu, cpu):
            lrn.py.copy_(torch.from_numpy(py0))
            lrn.w.copy_(torch.from_numpy(w0))
            lrn.step(blk, *lrn.block_tensors(blk))
        np.testing.assert_allclose(gpu.py.cpu().numpy(), cpu.py.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gpu.w.cpu().numpy(), cpu.w.numpy(),
                                   rtol=1e-5, atol=1e-6)
    pg, pc = gpu.run(), cpu.run()
    np.testing.assert_allclose(gpu.w.cpu().numpy(), cpu.w.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(pg.logloss, pc.logloss, rtol=1e-5)
    assert abs(pg.exact_auc - pc.exact_auc) <= 1e-4


def test_cuda_predict_on_a_bcd_checkpoint_launches_pull_pairs(card, tmp_path):
    """task=predict on a BCD checkpoint scores through the SGD eval path:
    at V_dim = 0 kernel=auto is pairs over planar leaves, so B1 (K = 0)
    and no apply kernel; the scores are the CPU's."""
    from difacto_tpu_torch import cli

    argv = _bcd_files(tmp_path) + ["max_num_epochs=2"]
    assert cli.main([*argv, f"model_out={tmp_path / 'm'}"]) == 0
    pred = [*argv[1:], f"data_in={tmp_path / 'va.svm'}", "task=predict",
            f"model_in={tmp_path / 'm'}"]
    cuda.reset_launches()
    assert cli.main([*pred, f"pred_out={tmp_path / 'g.txt'}"]) == 0
    launches = dict(cuda.LAUNCHES)
    assert launches["pull_pairs"] == 1  # 800 rows: one batch
    assert sum(launches.values()) == 1, launches
    assert cli.main([*pred, f"pred_out={tmp_path / 'c.txt'}"],
                    device="cpu") == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "g.txt"),
                               np.loadtxt(tmp_path / "c.txt"), rtol=2e-5,
                               atol=1e-5)


def test_cuda_memory_uri_round_trip_of_a_card_checkpoint(card, tmp_path):
    """A model trained on the card, saved to and loaded from memory://,
    keeps every bit; predictions from it equal the local copy's."""
    fsspec = pytest.importorskip("fsspec")
    from difacto_tpu_torch import cli
    from difacto_tpu_torch.utils import checkpoint

    argv = _bcd_files(tmp_path)[:-3] + ["V_dim=4", "lr_eta=0.1",
                                        "max_num_epochs=1"]
    assert cli.main([*argv, f"model_out={tmp_path / 'm'}"]) == 0
    assert cli.main([*argv, "model_out=memory://cudabucket/m"]) == 0
    local, _ = checkpoint.load(str(tmp_path / "m"))
    remote, meta = checkpoint.load("memory://cudabucket/m")
    assert meta["epoch"] == 1
    for name in LEAVES:
        # the card's index_add_ is atomic only on the XLA path; pairs
        # repeat their bits
        assert torch.equal(getattr(local, name), getattr(remote, name)), name
    outs = []
    for model, out in ((str(tmp_path / "m"), str(tmp_path / "p.txt")),
                       ("memory://cudabucket/m", "memory://cudabucket/p.txt")):
        assert cli.main([*argv, f"data_in={tmp_path / 'va.svm'}",
                         "task=predict", f"model_in={model}",
                         f"pred_out={out}"]) == 0
        with fsspec.open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    fsspec.filesystem("memory").rm("/cudabucket", recursive=True)


def test_cuda_trace_names_the_kernels(card, tmp_path, monkeypatch):
    """DIFACTO_PROFILE on the card: one Chrome trace of the first train
    epoch, naming the row-major pair kernels and B3 it launched."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.utils import arg_parser, tracing

    tracing.reset()
    monkeypatch.setenv("DIFACTO_PROFILE", str(tmp_path / "prof"))
    argv = _bcd_files(tmp_path)[:-3] + ["V_dim=4", "max_num_epochs=2"]
    SGDLearner(Config.from_kwargs(arg_parser.parse(argv))).run()
    files = list((tmp_path / "prof").iterdir())
    assert [p.name for p in files] == ["train_epoch_0.pt.trace.json"]
    import json

    names = {e.get("name", "") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    for kernel in ("rowmajor_pull_kernel", "segsum_tiles_kernel",
                   "rowmajor_apply_kernel"):
        assert any(kernel in n for n in names), kernel


# -- K1: the apply over S sorted segments (the sharded store owner's receive
# stream): csrc/seg_merge.cu's merge, then the one-stream kernels
# (csrc/apply_pairs.cu apply_pairs_kernel, csrc/rowmajor_pairs.cu
# rowmajor_apply_kernel<VEC, false>); the search design kept as the
# yardstick (apply_pairs_segs_kernel, rowmajor_apply_kernel<VEC, true>)

def seg_stream(rng, S, C=256, n=N, disjoint=False, fill=0.8):
    """K1's stream: S segments of C lanes, each sorted with a sentinel
    (``n``) tail. The ids of every segment come from one pool, so they
    repeat across segments, and are drawn with replacement, so they also
    repeat within one; ``disjoint`` gives each segment its own slice of
    the pool. Returns (uids i32 [S*C], valid bool [S*C])."""
    pool = rng.choice(n, size=int(C * fill) * S, replace=False)
    segs = []
    for s in range(S):
        src = pool[s::S] if disjoint else pool[:int(C * fill) * 2]
        k = int(C * fill) - int(rng.integers(0, C // 8))
        seg = np.full(C, n, np.int32)
        seg[:k] = np.sort(rng.choice(src, size=k, replace=True))
        segs.append(seg)
    uids = np.concatenate(segs)
    return uids, uids < n


def seg_payload(K, valid, rng, integer=False):
    """gw | gV | add_cnt | touch over a K1 stream, zero on its sentinel
    lanes; ``integer``: all rows in [1, 8] on the real lanes."""
    u = valid.shape[0]
    vf = valid.astype(np.float32)
    if integer:
        return rng.integers(1, 9, (3 + K, u)).astype(np.float32) * vf
    grads = rng.normal(size=(1 + K, u)).astype(np.float32) * vf
    addc = rng.integers(1, 4, u).astype(np.float32) * vf
    return np.concatenate([grads, addc[None], vf[None]], axis=0)


# K1's merge cases (tests/test_torch_k1_merge.py holds the plain merge
# against NumPy and JAX on them). A small Zipf batch (rows x nnz into
# 2^bits table rows) for the prepped streams; its row count divides by 2,
# 3 and 4
PREP_ROWS, PREP_NNZ, PREP_BITS = 96, 12, 12


def prep_stream(S: int, seed: int):
    """Owner 0's receive stream of a Zipf batch prepped over S row groups
    (chip_smoke.py's ``k1_stream`` at a small shape): S segments of C
    lanes, C the pairs path's capacity (the largest bucket fill,
    W-aligned, up the ladder), segment s the sorted ids group s sends to
    owner 0, then the local sentinel ``rows_per_shard``. Returns (uids,
    valid, C, rows_per_shard)."""
    from difacto_tpu_torch.data.prep import prep_batch_sharded
    from difacto_tpu_torch.parallel.store import (PAIR_WINDOW, _cap_ladder,
                                                  _round_up)
    from difacto_tpu_torch.probes.common import flagship_batch

    num_rows = 3 << PREP_BITS  # divisible by 2, 3 and 4
    rps = num_rows // S
    pb = prep_batch_sharded(flagship_batch(seed, PREP_ROWS, PREP_NNZ,
                                           PREP_BITS + 1), num_rows, S)
    C = _cap_ladder(_round_up(pb.max_fill, PAIR_WINDOW))
    segs = []
    for u in pb.uids.reshape(S, pb.ub):
        ids = u[u < rps]
        seg = np.full(C, rps, np.int32)
        seg[:len(ids)] = ids
        segs.append(seg)
    uids = np.concatenate(segs)
    return uids, uids < rps, C, rps


def k1_case(case: str, seed: int):
    """(uids i32 [S*C], valid, C, table rows = the sentinel) of a case."""
    rng = np.random.default_rng(seed)
    if case.startswith("prep_s"):
        return prep_stream(int(case[-1]), seed)
    if case == "all_sentinel":    # segment 1 of 3 holds no id
        uids, _ = seg_stream(rng, 3)
        uids[256:512] = N
    elif case == "no_sentinel":   # segment 0 of 2 is full of real ids
        uids, _ = seg_stream(rng, 2)
        uids[:256] = np.sort(rng.choice(N, size=256, replace=True))
    else:                         # "s<S>": S segments of the pool
        uids, _ = seg_stream(rng, int(case[1:]))
    return uids, uids < N, 256, N


K1_CASES = ("s1", "s2", "s3", "s4", "all_sentinel", "no_sentinel", "prep_s2",
           "prep_s3", "prep_s4")


K1_NAMES = {"planar": "apply_pairs_segs", "packed": "apply_rowmajor_segs"}


def k1_state(s, layout, card):
    st = state_from_numpy(s, card)
    return pack_state(st) if layout == "packed" else st


def k1_planar(st):
    return unpack_state(st) if hasattr(st, "tbl") else st


@pytest.mark.parametrize("layout", ["planar", "packed"])
@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (3, "sgd", "adagrad", 2),
                                             (16, "adagrad", "sgd", 0),
                                             (130, "ftrl", "adagrad", 0)])
def test_cuda_k1_matches_plain(card, layout, S, K, wupd, vupd, tff):
    """K1 against its plain version (a stable sort, then the one-stream
    plain apply: the kernels' summation order) at B2's tolerance (the
    plain division runs as a multiply by the reciprocal on the card); both
    layouts give the same bits; rows no lane names keep theirs; a second
    call repeats the bits (no atomics)."""
    rng = np.random.default_rng(300 + 7 * S + K)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng)
    uids_np, valid = seg_stream(rng, S)
    uids = torch.from_numpy(uids_np).to(card)
    pay = torch.from_numpy(seg_payload(K, valid, rng)).to(card)
    C = uids_np.shape[0] // S
    name = K1_NAMES[layout]
    n0 = cuda.LAUNCHES[name]
    got = k1_planar(pair_sweep.apply_pairs(k1_state(s, layout, card), uids,
                                           pay, p, seg_len=C))
    assert cuda.LAUNCHES[name] == n0 + 1
    ref = pair_sweep.apply_pairs_segs_plain(state_from_numpy(s, card), uids,
                                            pay, p, C)
    other = k1_planar(pair_sweep.apply_pairs(
        k1_state(s, "planar" if layout == "packed" else "packed", card),
        uids, pay, p, seg_len=C))
    again = k1_planar(pair_sweep.apply_pairs(k1_state(s, layout, card), uids,
                                             pay, p, seg_len=C))
    touched = torch.zeros(N, dtype=torch.bool, device=card)
    touched[uids[torch.from_numpy(valid).to(card)].long()] = True
    for leaf in LEAVES:
        x = getattr(got, leaf)
        torch.testing.assert_close(x, getattr(ref, leaf), rtol=1e-5,
                                   atol=1e-6, msg=leaf)
        assert torch.equal(x, getattr(other, leaf)), leaf
        assert torch.equal(x, getattr(again, leaf)), leaf
        orig = torch.from_numpy(s[leaf]).to(card)
        assert torch.equal(x[..., ~touched], orig[..., ~touched]), leaf


@pytest.mark.parametrize("layout", ["planar", "packed"])
def test_cuda_k1_exact_on_integers(card, layout):
    """An integer payload in [1, 8] through SGD with unit rates on a zero
    table: w = -sum(gw), V = -sum(gV), cnt = sum(add_cnt), exact in
    float32, so a lane lost or added twice, in any segment, fails."""
    rng = np.random.default_rng(320)
    K = 5
    p = port_params(V_dim=K, w_updater="sgd", V_updater="sgd", lr_eta=1.0,
                    l2=0.0, V_lr_eta=1.0, V_l2=0.0, V_threshold=0)
    s = {k: np.zeros_like(v) for k, v in state_np(K, rng).items()}
    uids_np, valid = seg_stream(rng, 4)
    uids = torch.from_numpy(uids_np).to(card)
    pay_np = seg_payload(K, valid, rng, integer=True)
    pay = torch.from_numpy(pay_np).to(card)
    got = k1_planar(pair_sweep.apply_pairs(k1_state(s, layout, card), uids,
                                           pay, p, seg_len=256))
    # the float64 sums of every id's lanes
    ids = uids_np[valid].astype(np.int64)
    exp = np.zeros((3 + K, N))
    for r in range(3 + K):
        np.add.at(exp[r], ids, pay_np[r, valid].astype(np.float64))
    assert np.array_equal(got.w.cpu().numpy(), -exp[0].astype(np.float32))
    assert np.array_equal(got.V.cpu().numpy(),
                          -exp[1:1 + K].astype(np.float32))
    assert np.array_equal(got.cnt.cpu().numpy(),
                          exp[1 + K].astype(np.float32))


@pytest.mark.parametrize("layout", ["planar", "packed"])
def test_cuda_k1_disjoint_segments_give_the_one_stream_bits(card, layout):
    """Segments with disjoint ids: each row's lanes lie in one segment, so
    K1 gives the bits of the one-stream kernel on the same lanes merged
    into one sorted stream (a stable sort)."""
    rng = np.random.default_rng(330)
    K = 16
    p = port_params(V_dim=K)
    s = state_np(K, rng)
    uids_np, valid = seg_stream(rng, 3, disjoint=True)
    pay_np = seg_payload(K, valid, rng)
    order = np.argsort(uids_np, kind="stable")
    got = pair_sweep.apply_pairs(
        k1_state(s, layout, card), torch.from_numpy(uids_np).to(card),
        torch.from_numpy(pay_np).to(card), p, seg_len=256)
    one = pair_sweep.apply_pairs(
        k1_state(s, layout, card), torch.from_numpy(uids_np[order]).to(card),
        torch.from_numpy(np.ascontiguousarray(pay_np[:, order])).to(card), p)
    got, one = k1_planar(got), k1_planar(one)
    for leaf in LEAVES:
        assert torch.equal(getattr(got, leaf), getattr(one, leaf)), leaf


@pytest.mark.parametrize("layout", ["planar", "packed"])
def test_cuda_k1_one_segment_gives_todays_bits(card, layout):
    """``seg_len`` = the stream's length (one segment) gives the bits of
    the one-stream call, ``seg_len=None``, which launches today's kernel."""
    rng = np.random.default_rng(340)
    K = 16
    p = port_params(V_dim=K)
    s = state_np(K, rng)
    uids_np, valid = sorted_uids(rng, repeat=True)
    uids = torch.from_numpy(uids_np).to(card)
    pay = torch.from_numpy(payload(K, valid, rng)).to(card)
    one_name = {"planar": "apply_pairs", "packed": "apply_rowmajor"}[layout]
    n0 = cuda.LAUNCHES[one_name]
    today = k1_planar(pair_sweep.apply_pairs(k1_state(s, layout, card), uids,
                                             pay, p))
    assert cuda.LAUNCHES[one_name] == n0 + 1
    seg = k1_planar(pair_sweep.apply_pairs(k1_state(s, layout, card), uids,
                                           pay, p, seg_len=U))
    for leaf in LEAVES:
        assert torch.equal(getattr(today, leaf), getattr(seg, leaf)), leaf


@pytest.mark.parametrize("P", [3, 19, 133])
@pytest.mark.parametrize("case", K1_CASES)
def test_cuda_merge_matches_plain(card, case, P):
    """The merge kernel (csrc/seg_merge.cu) against its plain version (a
    stable sort and a gather), exact: the merged ids and every payload
    row; one launch a call."""
    uids_np, valid, C, n = k1_case(case, 800 + K1_CASES.index(case))
    rng = np.random.default_rng(810 + P)
    pay_np = rng.normal(size=(P, uids_np.shape[0])).astype(np.float32)
    uids, pay = torch.from_numpy(uids_np).to(card), torch.from_numpy(
        pay_np).to(card)
    n0 = cuda.LAUNCHES["merge_segments"]
    mu, mp = pair_sweep.merge_segments(uids, pay, C)
    assert cuda.LAUNCHES["merge_segments"] == n0 + 1
    ru, rp = pair_sweep.merge_segments_plain(uids, pay, C)
    assert torch.equal(mu, ru) and torch.equal(mp, rp)
    order = np.argsort(uids_np, kind="stable")
    assert np.array_equal(mu.cpu().numpy(), uids_np[order])
    assert np.array_equal(mp.cpu().numpy(), pay_np[:, order])


K1_SEARCH_NAMES = {"planar": "apply_pairs_segs_search",
                   "packed": "apply_rowmajor_segs_search"}
ONE_STREAM_NAMES = {"planar": "apply_pairs", "packed": "apply_rowmajor"}


@pytest.mark.parametrize("layout", ["planar", "packed"])
@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (3, "sgd", "adagrad", 2),
                                             (16, "adagrad", "sgd", 0),
                                             (130, "ftrl", "adagrad", 0)])
def test_cuda_k1_merge_matches_search(card, layout, S, K, wupd, vupd, tff):
    """K1 by the merge (the path's route) bit for bit against the search
    design (the yardstick, ``apply_pairs_segs_search``) and against the
    one-stream kernel on the stream merged by NumPy's stable argsort, over
    test_cuda_k1_matches_plain's grid; a K1 call counts one merge and one
    K1 launch and nothing under the one-stream names, the yardstick one
    launch under its own name."""
    rng = np.random.default_rng(900 + 7 * S + K)
    p = port_params(V_dim=K, w_updater=wupd, V_updater=vupd,
                    tail_feature_filter=tff)
    s = state_np(K, rng)
    uids_np, valid = seg_stream(rng, S)
    pay_np = seg_payload(K, valid, rng)
    uids = torch.from_numpy(uids_np).to(card)
    pay = torch.from_numpy(pay_np).to(card)
    C = uids_np.shape[0] // S
    names = (K1_NAMES[layout], K1_SEARCH_NAMES[layout],
             ONE_STREAM_NAMES[layout], "merge_segments")
    n0 = {k: cuda.LAUNCHES[k] for k in names}
    got = k1_planar(pair_sweep.apply_pairs(k1_state(s, layout, card), uids,
                                           pay, p, seg_len=C))
    assert {k: cuda.LAUNCHES[k] - n0[k] for k in names} == {
        K1_NAMES[layout]: 1, K1_SEARCH_NAMES[layout]: 0,
        ONE_STREAM_NAMES[layout]: 0, "merge_segments": 1}
    search = k1_planar(pair_sweep.apply_pairs_segs_search(
        k1_state(s, layout, card), uids, pay, p, C))
    assert {k: cuda.LAUNCHES[k] - n0[k] for k in names} == {
        K1_NAMES[layout]: 1, K1_SEARCH_NAMES[layout]: 1,
        ONE_STREAM_NAMES[layout]: 0, "merge_segments": 1}
    order = np.argsort(uids_np, kind="stable")
    one = k1_planar(pair_sweep.apply_pairs(
        k1_state(s, layout, card), torch.from_numpy(uids_np[order]).to(card),
        torch.from_numpy(np.ascontiguousarray(pay_np[:, order])).to(card), p))
    for leaf in LEAVES:
        assert torch.equal(getattr(got, leaf), getattr(search, leaf)), leaf
        assert torch.equal(getattr(got, leaf), getattr(one, leaf)), leaf


def two_rank_steps(out: str) -> None:
    """One rank of the two-rank sharded step on the card (run by
    difacto_tpu_torch.parallel.launch): four prepped train steps of the
    flagship's shape cut down, on kernel=auto, then an eval step; rank 0
    writes the gathered table and the metrics."""
    import torch.distributed as dist

    from difacto_tpu_torch.parallel.store import ShardedStore

    cfg, batches, start = two_rank_case()
    store = ShardedStore(FMUpdater(cfg.model), cfg)
    state = store.place_state(state_from_numpy(start))
    res = two_rank_drive(store, state, batches)
    if dist.get_rank() == 0:
        np.savez(out, **res)


def two_rank_case():
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.probes.common import flagship_batch

    cfg = Config.from_kwargs([("batch_size", "2048"), ("num_bits", "16"),
                              ("max_nnz_per_row", "40"), ("V_dim", "16"),
                              ("store", "sharded")])
    batches = [flagship_batch(90 + i, 2048, 40, 16) for i in range(4)]
    return cfg, batches, state_np(16, np.random.default_rng(350), n=1 << 16)


def two_rank_drive(store, state, batches) -> dict:
    from difacto_tpu_torch.data.prep import (build_sorted_slots,
                                             build_sorted_slots_sharded,
                                             prep_batch, prep_batch_sharded)
    from difacto_tpu_torch.parallel.store import ShardedStore
    from difacto_tpu_torch.utils.checkpoint import state_to_numpy

    sharded = isinstance(store, ShardedStore)
    losses = []
    for b in batches:
        if sharded:
            pb = prep_batch_sharded(b, store.num_rows, store.S)
            pb.sorted_slots = build_sorted_slots_sharded(pb)
        else:
            pb = prep_batch(b, store.num_rows)
            pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals)
        state, m = store.train_step_prepped(state, pb)
        losses.append(float(m.logloss_sum))
    host = store.gather_state(state) if sharded else state
    return {"losses": np.asarray(losses), **state_to_numpy(host)}


def test_cuda_two_rank_gloo_step_matches_local_store(card, tmp_path):
    """Two gloo ranks on the one card (ShardedStore, K1 on each owner)
    against LocalStore on the card over the same batches from the same
    state: the JAX package's local-against-sharded tolerance
    (tests/test_store_equiv.py: rtol and atol 2e-4, logloss rtol 1e-4)."""
    from difacto_tpu_torch.parallel.launch import run_ranks
    from difacto_tpu_torch.parallel.store import LocalStore

    out = str(tmp_path / "ranks.npz")
    cuda.build()  # once, before the ranks load it
    run_ranks("test_torch_cuda:two_rank_steps", 2, [out], timeout=300,
              path=str(pathlib.Path(__file__).parent))
    got = np.load(out)
    cfg, batches, start = two_rank_case()
    store = LocalStore(FMUpdater(cfg.model), cfg, device=card)
    ref = two_rank_drive(store, store.place_state(state_from_numpy(start)),
                         batches)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for leaf in LEAVES:
        np.testing.assert_allclose(got[leaf], ref[leaf], rtol=2e-4,
                                   atol=2e-4, err_msg=leaf)


@pytest.mark.parametrize("layout", ["packed", "planar"])
def test_cuda_two_process_cli_matches_local_store(card, tmp_path, layout):
    """``python -m difacto_tpu_torch conf`` as two processes under the env
    contract, sharing the card (B1, B3 and K1 on the row-major table, or
    on planar leaves), trains 2 epochs over the two byte-range parts of a
    small set; the per-process checkpoint is LocalStore's on the card
    over the same global stream (the parts zipped, the shorter padded
    with empty batches), at rtol and atol 2e-4, and the two processes'
    predict part files concatenate to a one-process predict of the file
    set (a LocalStore)."""
    from difacto_tpu_torch import cli
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.batch_iter import Batch, BatchIter
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.data.synthetic import make_ctr_data, write_libsvm
    from difacto_tpu_torch.parallel.launch import run_processes
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.utils import arg_parser, checkpoint
    from difacto_tpu_torch.utils.checkpoint import state_to_numpy

    train, val = str(tmp_path / "train.svm"), str(tmp_path / "val.svm")
    write_libsvm(make_ctr_data(5000, num_fields=10, vocab_per_field=300,
                               seed=1), train)
    write_libsvm(make_ctr_data(1000, num_fields=10, vocab_per_field=300,
                               seed=2), val)
    conf = tmp_path / "fm.conf"
    conf.write_text(f"data_in = {train}\ndata_val = {val}\nbatch_size = 512\n"
                    "num_bits = 14\nmax_nnz_per_row = 12\nV_dim = 8\n"
                    "lr_eta = 0.1\nl1 = 0.1\nV_lr_eta = 0.05\n"
                    f"max_num_epochs = 2\nshuffle = 0\nlayout = {layout}\n")
    model = str(tmp_path / "model")
    cuda.build()  # once, before the processes load it
    run_processes(["-m", "difacto_tpu_torch", str(conf),
                   f"model_out={model}"], 2, timeout=300)
    run_processes(["-m", "difacto_tpu_torch", str(conf), "task=predict",
                   f"model_in={model}", f"data_in={val}",
                   f"pred_out={tmp_path / 'pred.txt'}"], 2, timeout=300)
    cfg = Config.from_kwargs(arg_parser.parse([str(conf)]))
    store = LocalStore(FMUpdater(cfg.model), cfg, device=card)
    state = store.init_state(cfg.data.seed)
    parts = [list(BatchIter(train, batch_size=256, max_nnz=12, num_bits=14,
                            part_index=range(p, p + 1), num_parts=2))
             for p in (0, 1)]
    empty = Batch(np.full((256, 12), -1, np.int32),
                  np.zeros((256, 12), np.float32), np.zeros(256, np.float32),
                  np.zeros(256, np.float32))
    n = max(map(len, parts))
    for _ in range(2):
        for i in range(n):
            step = [s[i] if i < len(s) else empty for s in parts]
            pb = prep_batch(Batch(*(np.concatenate([getattr(b, f)
                                                    for b in step])
                                    for f in ("ids", "vals", "labels",
                                              "mask"))), store.num_rows)
            pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals)
            state, _ = store.train_step_prepped(state, pb)
    ref = state_to_numpy(state)
    got, meta = checkpoint.load_full(model)
    assert meta["process_count"] == 2
    got = state_to_numpy(got)
    for leaf in LEAVES:
        np.testing.assert_allclose(got[leaf], ref[leaf], rtol=2e-4,
                                   atol=2e-4, err_msg=leaf)
    one = tmp_path / "one.txt"
    assert cli.main([str(conf), "task=predict", f"model_in={model}",
                     f"data_in={val}", f"pred_out={one}"]) == 0
    np.testing.assert_allclose(
        np.concatenate([np.loadtxt(tmp_path / f"pred.txt.part{p}")
                        for p in (0, 1)]), np.loadtxt(one), rtol=2e-4,
        atol=2e-4)
