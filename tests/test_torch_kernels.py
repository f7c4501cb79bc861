"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of difacto_tpu_torch runs its kernel's plain
PyTorch version; here those are held against the JAX kernels run in
interpret mode, at the sizes of tests/test_pair_sweep.py,
tests/test_segsum.py and tests/test_sweep.py, from the same NumPy inputs (made by the helpers of
tests/test_torch_cuda.py, where the hand-written CUDA kernels themselves
are held against the plain versions on the card).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.config import FMParam as JFMParam
from difacto_tpu.ops import pair_sweep as jps
from difacto_tpu.ops import segsum as jseg
from difacto_tpu.ops import sweep as jsweep
from difacto_tpu.ops import sweep_ms as jsweep_ms
from difacto_tpu.ops.sweep_ms import fused_table_update as j_fused
from difacto_tpu.updaters import updater as jupd
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu.updaters.updater import FMUpdater as JFMUpdater
from difacto_tpu_torch.ops import pair_sweep, segsum, sweep, sweep_ms
from difacto_tpu_torch.ops.sweep_ms import fused_table_update
from difacto_tpu_torch.updaters.updater import (FMUpdater, PackedFMState,
                                                pack_state, unpack_state)
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy
from test_torch_cuda import (LEAVES, N, N2, R2, U, id_streams,
                             payload as _payload, port_params,
                             slot_payload, sorted_uids as _sorted_uids,
                             state_np as _state_np)

torch.set_num_threads(2)

BLOCK_ROWS = 512
T = torch.from_numpy


def _params(**kw):
    """The same settings as a JAX FMParam and a port FMParam."""
    tp = port_params(**kw)
    jp = JFMParam()
    for f in dataclasses.fields(tp):
        setattr(jp, f.name, getattr(tp, f.name))
    return jp, tp


def _jstate(s):
    return JFMState(**{k: jnp.asarray(v) for k, v in s.items()})


def _meta(uids):
    m = jps.build_pair_meta(uids, N, BLOCK_ROWS)
    return (jnp.asarray(m.blocks), jnp.asarray(m.wins), jnp.asarray(m.first),
            jnp.asarray(m.wfirst))


@pytest.mark.parametrize("K", [0, 4])
def test_pull_pairs_matches_jax(K):
    rng = np.random.default_rng(K)
    jp, tp = _params(V_dim=K)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    ref = jps.pull_pairs(_jstate(s), jnp.asarray(uids), _meta(uids), jp,
                         block_rows=BLOCK_ROWS, interpret=True)
    # lanes no pair visits are undefined in the Pallas output; the store
    # masks them with `valid` — the port's pull zeroes sentinel lanes
    ref = np.where(valid[None, :], np.asarray(ref), 0.0)
    got = pair_sweep.pull_pairs(state_from_numpy(s), torch.from_numpy(uids),
                                tp)
    assert got.shape == (1 + K, U)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert np.all(got.numpy()[:, ~valid] == 0.0)


@pytest.mark.parametrize(
    "K,wupd,vupd,tff",
    [
        (4, "ftrl", "adagrad", 0),
        (0, "ftrl", "adagrad", 0),
        (2, "adagrad", "sgd", 0),
        (3, "sgd", "adagrad", 2),
    ],
)
@pytest.mark.parametrize("repeat", [False, True])
def test_apply_pairs_matches_jax(K, wupd, vupd, tff, repeat):
    rng = np.random.default_rng(10 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng, repeat=repeat)
    pay = _payload(K, valid, rng)
    ref = jps.apply_pairs(_jstate(s), jnp.asarray(uids), jnp.asarray(pay),
                          _meta(uids), jp, block_rows=BLOCK_ROWS,
                          interpret=True)
    st = state_from_numpy(s)
    out = pair_sweep.apply_pairs(st, torch.from_numpy(uids),
                                 torch.from_numpy(pay), tp)
    assert out is st  # in place
    got = state_to_numpy(out)
    touched = np.zeros(N, bool)
    touched[uids[valid]] = True
    for name in LEAVES:
        a, b = np.asarray(getattr(ref, name)), got[name]
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        # untouched rows keep their exact bits
        assert np.array_equal(b[..., ~touched], s[name][..., ~touched]), name


@pytest.mark.parametrize(
    "K,wupd,vupd,tff",
    [
        (4, "ftrl", "adagrad", 0),
        (0, "ftrl", "adagrad", 0),
        (2, "adagrad", "sgd", 0),
        (3, "sgd", "adagrad", 2),
    ],
)
def test_updater_pull_and_update_match_jax_and_the_kernels(K, wupd, vupd,
                                                           tff):
    """The updater's plain pull/update (the reference of the table path)
    against the JAX updater's, and against the pull and apply kernels'
    plain versions on unique ids."""
    rng = np.random.default_rng(60 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    pay = _payload(K, valid, rng)
    ju, tu = JFMUpdater(jp), FMUpdater(tp)
    t_uids, t_valid = torch.from_numpy(uids), torch.from_numpy(valid)

    ref = np.asarray(ju.pull(_jstate(s), jnp.asarray(uids),
                             jnp.asarray(valid)))
    got = tu.pull(state_from_numpy(s), t_uids, t_valid)
    np.testing.assert_array_equal(got.numpy(), ref)
    kern = pair_sweep.pull_pairs(state_from_numpy(s), t_uids, tp)
    np.testing.assert_array_equal(kern.T.numpy(), ref)

    grads, add_cnt = pay[: 1 + K].T, pay[1 + K]
    ref = ju.update(_jstate(s), jnp.asarray(uids), jnp.asarray(grads),
                    jnp.asarray(add_cnt), jnp.asarray(valid))
    got = state_to_numpy(tu.update(state_from_numpy(s), t_uids,
                                   torch.from_numpy(grads),
                                   torch.from_numpy(add_cnt), t_valid))
    kern = state_to_numpy(pair_sweep.apply_pairs(
        state_from_numpy(s), t_uids, torch.from_numpy(pay), tp))
    for name in LEAVES:
        a = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got[name], a, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        # update adds masked deltas, apply writes new values: they agree
        # to float rounding
        np.testing.assert_allclose(kern[name], a, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 2),
                                             (2, "adagrad", "sgd", 0),
                                             (0, "sgd", "adagrad", 0)])
def test_fused_table_update_matches_jax(K, wupd, vupd, tff):
    rng = np.random.default_rng(20 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    R = 300
    s = {k: (v[..., :R] if v.ndim == 1 else v[:, :R])
         for k, v in _state_np(K, rng).items()}
    acc = _payload(K, np.arange(U) < 250, rng)[:, :R]
    vk = (s["V"], s["nV"]) if K else (None, None)
    ref = j_fused(jnp.asarray(acc), *(jnp.asarray(s[k]) for k in
                                      ("w", "z", "n", "cnt")),
                  *(None if v is None else jnp.asarray(v) for v in vk), jp, K)
    got = fused_table_update(
        torch.from_numpy(acc), *(torch.from_numpy(s[k]) for k in
                                 ("w", "z", "n", "cnt")),
        *(None if v is None else torch.from_numpy(v) for v in vk), tp, K)
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def _jax_segsum(pay, inv_p, ub):
    meta = jseg.build_seg_meta(inv_p, ub)
    return np.asarray(jseg.segsum_sorted(
        jnp.asarray(pay), jseg.lanes_2d(jnp.asarray(inv_p)),
        (jnp.asarray(meta.tiles), jnp.asarray(meta.wins),
         jnp.asarray(meta.first)),
        ub=ub, interpret=True,
    ))


@pytest.mark.parametrize(
    "bl,ub,pp,hi", [(4096, 1024, 8, 1024), (5000, 640, 24, 640),
                    (2048, 8192, 8, 600)]
)
def test_segsum_sorted_matches_jax(bl, ub, pp, hi):
    """``hi`` < ub leaves the top lanes uncovered: they must be exact 0."""
    rng = np.random.default_rng(bl + ub)
    lanes = np.sort(rng.integers(0, hi, bl)).astype(np.int32)
    inv_p = segsum.pad_sorted_stream(lanes)
    assert np.array_equal(inv_p, jseg.pad_sorted_stream(lanes))
    pay = rng.normal(size=(pp, inv_p.shape[0])).astype(np.float32)
    pay[:, bl:] = 0.0
    ref = _jax_segsum(pay, inv_p, ub)
    got = segsum.segsum_sorted(torch.from_numpy(pay),
                               torch.from_numpy(inv_p), ub).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    covered = np.zeros(ub, bool)
    covered[lanes] = True
    assert np.all(got[:, ~covered] == 0.0)


SWEEP_CASES = [
    (4, "ftrl", "adagrad", 0),
    (0, "ftrl", "adagrad", 0),
    (2, "adagrad", "sgd", 0),
    (3, "sgd", "adagrad", 2),
]


def _port_state(s, layout):
    st = state_from_numpy(s)
    return pack_state(st) if layout == "packed" else st


def _sweep_both(s, uids, valid, grads, addc, jp, tp, n=N, layout="planar"):
    """Pull then apply through JAX's ops/sweep.py (interpret mode, planar
    state) and the port's on a state of ``layout`` (a packed one is
    unpacked through ``state_to_numpy``); asserts the pull (exact) and the
    in-place apply (atol 1e-5, rows no id names keep their bits)."""
    ref = jsweep.sweep_pull(_jstate(s), jnp.asarray(uids), jnp.asarray(valid),
                            jp, block_rows=BLOCK_ROWS, interpret=True)
    got = sweep.sweep_pull(_port_state(s, layout), T(uids), T(valid), tp,
                           block_rows=BLOCK_ROWS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jsweep.sweep_apply(_jstate(s), jnp.asarray(uids), jnp.asarray(grads),
                             jnp.asarray(addc), jnp.asarray(valid), jp,
                             block_rows=BLOCK_ROWS, interpret=True)
    st = _port_state(s, layout)
    # the port takes the per-key gradients planar [1+K, U]
    out = sweep.sweep_apply(st, T(uids), T(grads.T.copy()), T(addc),
                            T(valid), tp, block_rows=BLOCK_ROWS)
    assert out is st  # in place
    got = state_to_numpy(out)
    named = np.zeros(n, bool)
    named[uids[valid]] = True
    for name in LEAVES:
        a = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got[name], a, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert np.array_equal(got[name][..., ~named], s[name][..., ~named])


@pytest.mark.parametrize("K,wupd,vupd,tff", SWEEP_CASES)
def test_sweep_packed_pull_and_apply_match_jax(K, wupd, vupd, tff):
    """The sweep wrappers on a PackedFMState (pack, run, unpack, all six
    leaves) against JAX's sweep kernels in interpret mode on the planar
    state, over the cases of the planar test."""
    rng = np.random.default_rng(90 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    grads = rng.normal(size=(U, 1 + K)).astype(np.float32)
    addc = rng.integers(1, 4, U).astype(np.float32)
    _sweep_both(s, uids, valid, grads, addc, jp, tp, layout="packed")


def test_sweep_packed_dense_block_matches_jax():
    """400 ids in one 512-row block, over the row-major table."""
    K, n, u = 2, 1024, 400
    rng = np.random.default_rng(4)
    jp, tp = _params(V_dim=K, V_threshold=0)
    s = _state_np(K, rng, n=n)
    uids = np.sort(rng.choice(512, size=u, replace=False)).astype(np.int32)
    grads = rng.normal(size=(u, 1 + K)).astype(np.float32)
    _sweep_both(s, uids, np.ones(u, bool), grads, np.ones(u, np.float32), jp,
                tp, n=n, layout="packed")


@pytest.mark.parametrize("K,wupd,vupd,tff", SWEEP_CASES)
def test_sweep_pull_and_apply_match_jax(K, wupd, vupd, tff):
    """tests/test_sweep.py's cases: N 4096, block_rows 512."""
    rng = np.random.default_rng(90 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    grads = rng.normal(size=(U, 1 + K)).astype(np.float32)
    addc = rng.integers(1, 4, U).astype(np.float32)
    _sweep_both(s, uids, valid, grads, addc, jp, tp)


def test_sweep_dense_block_matches_jax():
    """tests/test_sweep.py's dense case: 400 ids in one 512-row block."""
    K, n, u = 2, 1024, 400
    rng = np.random.default_rng(4)
    jp, tp = _params(V_dim=K, V_threshold=0)
    s = _state_np(K, rng, n=n)
    uids = np.sort(rng.choice(512, size=u, replace=False)).astype(np.int32)
    valid = np.ones(u, bool)
    grads = rng.normal(size=(u, 1 + K)).astype(np.float32)
    _sweep_both(s, uids, valid, grads, np.ones(u, np.float32), jp, tp, n=n)


@pytest.mark.parametrize("layout", ["planar", "packed"])
@pytest.mark.parametrize("K", [0, 3])
def test_sweep_ms_two_streams_with_duplicates_match_jax(K, layout):
    """The multi-stream kernels themselves: two sorted streams with ids
    repeated within and across them, sentinel tails, one empty block; on
    the planar state and on the row-major table."""
    rng = np.random.default_rng(100 + K)
    jp, tp = _params(V_dim=K)
    s = _state_np(K, rng, n=N2)
    sid, off = id_streams(rng)
    pay = slot_payload(K, sid.shape[0], rng)
    real = sid < N2
    ref = np.asarray(jsweep_ms.sweep_pull_ms(
        _jstate(s), jnp.asarray(sid), jnp.asarray(off), jp, block_rows=R2,
        interpret=True))
    got = sweep_ms.sweep_pull_ms(_port_state(s, layout), T(sid), T(off), tp,
                                 block_rows=R2).numpy()
    # the sentinel slots are undefined in the TPU kernel, zero in the port
    np.testing.assert_array_equal(got[:, real], ref[:, real])
    assert np.all(got[:, ~real] == 0.0)
    ref = jsweep_ms.sweep_apply_ms(
        _jstate(s), jnp.asarray(sid), jnp.asarray(pay), jnp.asarray(off), jp,
        block_rows=R2, interpret=True)
    st = _port_state(s, layout)
    assert sweep_ms.sweep_apply_ms(st, T(sid), T(pay), T(off), tp,
                                   block_rows=R2) is st  # in place
    got = state_to_numpy(st)
    for name in LEAVES:
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    cnt = s["cnt"].copy()
    np.add.at(cnt, sid[real], pay[1 + K][real])
    np.testing.assert_array_equal(got["cnt"], cnt)


def test_sweep_wrappers_refuse_a_ragged_table():
    p = port_params(V_dim=2)
    st = state_from_numpy(_state_np(2, np.random.default_rng(0), n=N2))
    sid = torch.full((8,), N2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        sweep_ms.sweep_pull_ms(st, sid, torch.zeros((1, 4), dtype=torch.int32),
                               p, block_rows=300)
    with pytest.raises(ValueError, match="offsets has shape"):
        sweep_ms.sweep_apply_ms(st, sid, torch.zeros((5, 8)),
                                torch.zeros((1, 3), dtype=torch.int32), p,
                                block_rows=R2)


# ---------------------------------------------------------------------------
# the row-major table (layout=packed): PackedFMState, and pull_pairs /
# apply_pairs over it. On the CPU the wrappers take the plain versions,
# which read and write the table through the state's column views.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [0, 4])
def test_pack_unpack_and_init_packed_match_jax(K):
    """pack_state / unpack_state against JAX's (copies of the same
    floats: exact), JAX's ``PackedFMState.tbl`` carried in as a NumPy
    array, and ``init_state_packed`` against ``pack_state(init_state)``
    from the same generator (exact)."""
    rng = np.random.default_rng(70 + K)
    s = _state_np(K, rng)
    jpacked = jupd.pack_state(_jstate(s))
    packed = pack_state(state_from_numpy(s))
    assert isinstance(packed, PackedFMState)
    assert (packed.num_rows, packed.k) == (N, K)
    assert packed.tbl.shape == (N, 4 + 2 * K) and packed.tbl.is_contiguous()
    np.testing.assert_array_equal(packed.tbl.numpy(), np.asarray(jpacked.tbl))
    carried = state_from_numpy(np.asarray(jpacked.tbl), layout="packed")
    assert torch.equal(carried.tbl, packed.tbl)
    assert torch.equal(state_from_numpy(jpacked, layout="packed").tbl,
                       packed.tbl)
    back, jback = unpack_state(packed), jupd.unpack_state(jpacked)
    for name in LEAVES:
        leaf = getattr(back, name)
        assert leaf.is_contiguous(), name
        np.testing.assert_array_equal(leaf.numpy(), s[name], err_msg=name)
        np.testing.assert_array_equal(np.asarray(getattr(jback, name)),
                                      s[name], err_msg=name)
        # the packed state's leaves are views of its table
        np.testing.assert_array_equal(getattr(packed, name).numpy(), s[name])
    np.testing.assert_array_equal(state_to_numpy(packed)["V"], s["V"])
    _, tp = _params(V_dim=K)
    a = FMUpdater(tp).init_state_packed(N, 5, "cpu")
    b = pack_state(FMUpdater(tp).init_state(N, 5, "cpu"))
    assert torch.equal(a.tbl, b.tbl)
    if K:
        assert float(a.V.abs().max()) > 0


@pytest.mark.parametrize("K,thr", [(0, 2), (4, 2), (3, 0), (4, 10)])
def test_packed_pull_matches_jax_and_planar(K, thr):
    """pull_pairs over a PackedFMState against JAX ``FMUpdater.pull`` on
    JAX's PackedFMState (a gather and a mask: exact) and the bits of the
    planar plain version; sentinel lanes are 0."""
    rng = np.random.default_rng(80 + K)
    jp, tp = _params(V_dim=K, V_threshold=thr)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    ref = np.asarray(JFMUpdater(jp).pull(jupd.pack_state(_jstate(s)),
                                         jnp.asarray(uids),
                                         jnp.asarray(valid)))
    packed = pack_state(state_from_numpy(s))
    got = pair_sweep.pull_pairs(packed, T(uids), tp)
    assert got.shape == (1 + K, U)
    np.testing.assert_array_equal(got.numpy().T, ref)
    assert torch.equal(got, pair_sweep.pull_pairs(state_from_numpy(s),
                                                  T(uids), tp))
    assert np.all(got.numpy()[:, ~valid] == 0.0)
    up = FMUpdater(tp).pull(packed, T(uids), T(valid))
    np.testing.assert_array_equal(up.numpy(), ref)


@pytest.mark.parametrize(
    "K,wupd,vupd,tff,thr",
    [
        (4, "ftrl", "adagrad", 0, 2),
        (0, "ftrl", "adagrad", 0, 2),
        (2, "adagrad", "sgd", 0, 2),
        (3, "sgd", "adagrad", 2, 2),
        (4, "ftrl", "adagrad", 0, 0),
    ],
)
@pytest.mark.parametrize("repeat", [False, True])
def test_packed_apply_matches_jax_and_planar(K, wupd, vupd, tff, thr, repeat):
    """apply_pairs over a PackedFMState: the bits of the planar plain
    version (the same code over the table's column views) on unique and
    on repeated ids, rows no id names keep their bits, and on unique ids
    JAX ``FMUpdater.update`` on JAX's PackedFMState (it scatter-adds
    masked deltas where the apply writes new values: rtol 1e-6, atol
    1e-6, the planar test's tolerance). The updater's own update runs on
    the packed state too."""
    rng = np.random.default_rng(90 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff, V_threshold=thr)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng, repeat=repeat)
    pay = _payload(K, valid, rng)
    packed = pack_state(state_from_numpy(s))
    out = pair_sweep.apply_pairs(packed, T(uids), T(pay), tp)
    assert out is packed  # in place
    got = state_to_numpy(out)
    planar = state_to_numpy(pair_sweep.apply_pairs(
        state_from_numpy(s), T(uids), T(pay), tp))
    touched = np.zeros(N, bool)
    touched[uids[valid]] = True
    for name in LEAVES:
        np.testing.assert_array_equal(got[name], planar[name], err_msg=name)
        assert np.array_equal(got[name][..., ~touched],
                              s[name][..., ~touched]), name
    if repeat:
        return  # the updaters take unique ids
    grads, add_cnt = pay[: 1 + K].T, pay[1 + K]
    ref = jupd.unpack_state(JFMUpdater(jp).update(
        jupd.pack_state(_jstate(s)), jnp.asarray(uids), jnp.asarray(grads),
        jnp.asarray(add_cnt), jnp.asarray(valid)))
    upd = state_to_numpy(FMUpdater(tp).update(
        pack_state(state_from_numpy(s)), T(uids), T(grads), T(add_cnt),
        T(valid)))
    for name in LEAVES:
        a = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got[name], a, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(upd[name], a, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def _packed_case():
    rng = np.random.default_rng(99)
    _, tp = _params(V_dim=2)
    s = _state_np(2, rng)
    uids, valid = _sorted_uids(rng)
    pay = T(_payload(2, valid, rng))
    off = sweep.offsets_1(T(uids), N, BLOCK_ROWS)
    return tp, s, T(uids), pay, off


@pytest.mark.parametrize("kernel", ["apply_pairs2"])
def test_planar_only_kernels_refuse_a_packed_state(kernel):
    """``apply_pairs2`` reads planar leaves only and raises."""
    tp, s, uids, pay, _ = _packed_case()
    with pytest.raises(TypeError, match="layout=packed"):
        pair_sweep.apply_pairs2(pack_state(state_from_numpy(s)), uids, pay, tp)


@pytest.mark.parametrize("kernel", ["sweep_pull_ms", "sweep_apply_ms"])
def test_sweep_kernels_take_a_packed_state(kernel):
    """The sweep wrappers take the row-major table (csrc/rowmajor_sweep.cu)
    and give the bits of the planar state's result; the apply updates the
    table it was given."""
    tp, s, uids, pay, off = _packed_case()
    packed = pack_state(state_from_numpy(s))
    if kernel == "sweep_pull_ms":
        got = sweep_ms.sweep_pull_ms(packed, uids, off, tp,
                                     block_rows=BLOCK_ROWS)
        assert torch.equal(got, sweep_ms.sweep_pull_ms(
            state_from_numpy(s), uids, off, tp, block_rows=BLOCK_ROWS))
    else:
        out = sweep_ms.sweep_apply_ms(packed, uids, pay, off, tp,
                                      block_rows=BLOCK_ROWS)
        assert out is packed
        ref = sweep_ms.sweep_apply_ms(state_from_numpy(s), uids, pay, off,
                                      tp, block_rows=BLOCK_ROWS)
        for name, v in state_to_numpy(out).items():
            np.testing.assert_array_equal(v, state_to_numpy(ref)[name],
                                          err_msg=name)


@pytest.mark.parametrize("kernel", ["apply_pairs2", "sweep_pull_ms",
                                    "sweep_apply_ms"])
def test_packed_state_without_factors_on_repeated_streams(kernel):
    """A row-major table with K = 0 and two streams of ids repeated within
    and across them (the inputs test_sweep_kernels_take_a_packed_state
    lacks): ``apply_pairs2`` still refuses the table, on a stream of
    repeated ids; the sweep wrappers take it and give the bits of the
    planar state's result, the apply in place."""
    rng = np.random.default_rng(98)
    _, tp = _params(V_dim=0)
    if kernel == "apply_pairs2":
        uids, valid = _sorted_uids(rng, repeat=True)
        packed = pack_state(state_from_numpy(_state_np(0, rng)))
        pay = T(_payload(0, valid, rng))
        with pytest.raises(TypeError, match="layout=packed"):
            pair_sweep.apply_pairs2(packed, T(uids), pay, tp)
        return
    s = _state_np(0, rng, n=N2)
    sid, off = (T(a) for a in id_streams(rng))
    packed = pack_state(state_from_numpy(s))
    if kernel == "sweep_pull_ms":
        got = sweep_ms.sweep_pull_ms(packed, sid, off, tp, block_rows=R2)
        assert torch.equal(got, sweep_ms.sweep_pull_ms(
            state_from_numpy(s), sid, off, tp, block_rows=R2))
    else:
        pay = T(slot_payload(0, sid.shape[0], rng))
        out = sweep_ms.sweep_apply_ms(packed, sid, pay, off, tp,
                                      block_rows=R2)
        assert out is packed
        ref = sweep_ms.sweep_apply_ms(state_from_numpy(s), sid, pay, off, tp,
                                      block_rows=R2)
        for name, v in state_to_numpy(out).items():
            np.testing.assert_array_equal(v, state_to_numpy(ref)[name],
                                          err_msg=name)


@pytest.mark.parametrize(
    "bl,ub,pp,hi", [(4096, 1024, 8, 1024), (5000, 640, 24, 640),
                    (2048, 8192, 8, 600)]
)
def test_segsum_sorted_rows_matches_jax(bl, ub, pp, hi):
    """The row-major entry (payload ``[BLp, pp]``) against JAX's
    ``segsum_sorted`` on the transposed payload, over the cases of the
    planar test (rtol 1e-5, atol 1e-4: float association); the top lanes
    no slot covers are exact 0; and the bits of the planar entry's plain
    version."""
    rng = np.random.default_rng(bl + ub)
    lanes = np.sort(rng.integers(0, hi, bl)).astype(np.int32)
    inv_p = segsum.pad_sorted_stream(lanes)
    pay = rng.normal(size=(inv_p.shape[0], pp)).astype(np.float32)
    pay[bl:] = 0.0
    ref = _jax_segsum(np.ascontiguousarray(pay.T), inv_p, ub)
    got = segsum.segsum_sorted_rows(T(pay), T(inv_p), ub)
    assert got.shape == (pp, ub) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    covered = np.zeros(ub, bool)
    covered[lanes] = True
    assert np.all(got.numpy()[:, ~covered] == 0.0)
    assert torch.equal(got, segsum.segsum_sorted(T(pay).T.contiguous(),
                                                 T(inv_p), ub))
    assert torch.equal(got, segsum.segsum_sorted_chunks(
        T(pay).T.contiguous(), T(inv_p), ub))
