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
from difacto_tpu_torch.ops import cuda, pair_sweep, segsum, sweep_ms
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


@pytest.mark.parametrize("K", [0, 4])
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
                                             (3, "sgd", "adagrad", 2)])
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


@pytest.mark.parametrize("K", [0, 4, 40])
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
                                             (3, "sgd", "adagrad", 2)])
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
