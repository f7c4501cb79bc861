"""The kernel probes of the port (difacto_tpu_torch/probes) on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version. Here
those are held against the JAX package from the same NumPy inputs:
``apply_pairs2`` against the Pallas ``apply_pairs2`` in interpret mode
with its ``DualPairMeta`` schedule; the packed pull and apply against the
production Pallas ``pull_pairs`` / ``apply_pairs`` in interpret mode (the
packed Pallas kernels are closures inside ``scripts/hw_packed_pairs.py::
main``, which itself proves them bit-equal to the production ones); the
bisect kernels against float64 NumPy and against ``scripts/bisect_apply.
py::kernel`` / ``kernel4`` run through ``pl.pallas_call(interpret=True)``
at a small size; the slot accumulate against ``np.add.at`` in float64
(its Pallas kernel is a closure inside ``scripts/bench_slot_accum.py::
main``). The hand-written CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from difacto_tpu.ops import pair_sweep as jps
from difacto_tpu_torch.ops import pair_sweep
from difacto_tpu_torch.probes import (bench_slot_accum, bisect_apply, common,
                                      hw_apply2, hw_packed_pairs,
                                      segsum_designs)
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy
from scripts import bisect_apply as jbisect
from test_torch_cuda import (LEAVES, N, U, bisect_stream, payload as _payload,
                             sorted_uids as _sorted_uids,
                             state_np as _state_np)
from test_torch_kernels import BLOCK_ROWS, _jstate, _meta, _params

torch.set_num_threads(2)

T = torch.from_numpy


# ---------------------------------------------------------------------------
# B6 apply_pairs2
# ---------------------------------------------------------------------------


def _dual_meta(uids, n, block_rows):
    m = jps.build_dual_apply_meta(uids, n, block_rows)
    return tuple(jnp.asarray(a) for a in (m.blocks, m.wins_a, m.wins_b,
                                          m.first))


def _check_apply2(s, uids, pay, jp, tp, n, touched_ids):
    ref = jps.apply_pairs2(_jstate(s), jnp.asarray(uids), jnp.asarray(pay),
                           _dual_meta(uids, n, BLOCK_ROWS), jp,
                           block_rows=BLOCK_ROWS, interpret=True)
    st = state_from_numpy(s)
    out = pair_sweep.apply_pairs2(st, T(uids), T(pay), tp)
    assert out is st  # in place
    got = state_to_numpy(out)
    touched = np.zeros(n, bool)
    touched[touched_ids] = True
    for name in LEAVES:
        # atol 1e-5, the tolerance tests/test_pair_sweep.py holds the
        # Pallas kernel to: its sums run through one-hot matmuls
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
        # untouched rows keep their exact bits
        assert np.array_equal(got[name][..., ~touched],
                              s[name][..., ~touched]), name


@pytest.mark.parametrize("K,wupd", [(4, "ftrl"), (0, "ftrl"), (4, "adagrad")])
def test_apply_pairs2_matches_jax(K, wupd):
    rng = np.random.default_rng(200 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    _check_apply2(s, uids, _payload(K, valid, rng), jp, tp, N, uids[valid])


def test_apply_pairs2_dense_block_matches_jax():
    """Many ids in one table block (several unique windows, an odd count
    of them) and a window straddling a block boundary."""
    K, n = 2, 1024
    rng = np.random.default_rng(4)
    jp, tp = _params(V_dim=K, V_threshold=0, l1=1.0)
    s = _state_np(K, rng, n=n)
    raw = np.sort(np.concatenate(
        [rng.choice(512, size=300, replace=False),
         512 + rng.choice(128, size=80, replace=False)])).astype(np.int32)
    uids = np.full(U, n, np.int32)
    uids[: len(raw)] = raw
    valid = np.arange(U) < len(raw)
    _check_apply2(s, uids, _payload(K, valid, rng), jp, tp, n, raw)


@pytest.mark.parametrize("repeat", [False, True])
def test_apply_pairs2_is_apply_pairs_on_the_cpu(repeat):
    """One function, two kernel designs: the same plain version, also on
    runs of equal ids (which the Pallas dual schedule does not take)."""
    rng = np.random.default_rng(210)
    _, tp = _params(V_dim=3, tail_feature_filter=2)
    s = _state_np(3, rng)
    uids, valid = _sorted_uids(rng, repeat=repeat)
    pay = _payload(3, valid, rng)
    a = state_to_numpy(pair_sweep.apply_pairs2(state_from_numpy(s), T(uids),
                                               T(pay), tp))
    b = state_to_numpy(pair_sweep.apply_pairs(state_from_numpy(s), T(uids),
                                              T(pay), tp))
    for name in LEAVES:
        assert np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("stage", ["lanes", "tiles", "rmwonly", "first",
                                   "loadonly"])
def test_planar_apply_stage_words_on_the_cpu(stage):
    """The stage words of the planar apply's two wrappers on the CPU: the
    designs (``lanes``, ``tiles``) compute the function, the floor
    ``rmwonly`` leaves the state, and A and B, as they were; any other
    word (``first``, ``loadonly``) raises."""
    rng = np.random.default_rng(215)
    _, tp = _params(V_dim=3)
    s = _state_np(3, rng)
    uids, valid = _sorted_uids(rng, repeat=True)
    pay = T(_payload(3, valid, rng))
    a, b = hw_packed_pairs.pack_state(state_from_numpy(s))
    if stage not in pair_sweep.PLANAR_APPLY_STAGES:
        with pytest.raises(ValueError, match="stage"):
            pair_sweep.apply_pairs2(state_from_numpy(s), T(uids), pay, tp,
                                    stage)
        with pytest.raises(ValueError, match="stage"):
            hw_packed_pairs.apply_packed(a, b, T(uids), pay, tp, stage)
        return
    got = state_to_numpy(pair_sweep.apply_pairs2(state_from_numpy(s),
                                                 T(uids), pay, tp, stage))
    a2, b2 = hw_packed_pairs.apply_packed(a, b, T(uids), pay, tp, stage)
    assert a2 is a and b2 is b
    packed = state_to_numpy(hw_packed_pairs.unpack_state(a, b))
    want = s if stage == "rmwonly" else state_to_numpy(
        pair_sweep.apply_pairs(state_from_numpy(s), T(uids), pay, tp))
    for name in LEAVES:
        assert np.array_equal(got[name], want[name]), name
        assert np.array_equal(packed[name], want[name]), name


# ---------------------------------------------------------------------------
# S1 packed pull / apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [0, 4])
def test_pack_state_round_trip(K):
    s = _state_np(K, np.random.default_rng(220 + K))
    a, b = hw_packed_pairs.pack_state(state_from_numpy(s))
    assert a.shape == b.shape == (2 + K, N)
    assert np.array_equal(a.numpy(), np.concatenate(
        [s["w"][None], s["cnt"][None], s["V"]]))   # A = w | cnt | V
    assert np.array_equal(b.numpy(), np.concatenate(
        [s["z"][None], s["n"][None], s["nV"]]))    # B = z | n | nV
    back = state_to_numpy(hw_packed_pairs.unpack_state(a, b))
    for name in LEAVES:
        assert np.array_equal(back[name], s[name]), name


@pytest.mark.parametrize("K", [0, 4])
def test_pull_packed_matches_jax(K):
    rng = np.random.default_rng(230 + K)
    jp, tp = _params(V_dim=K)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    ref = np.asarray(jps.pull_pairs(
        _jstate(s), jnp.asarray(uids), _meta(uids), jp,
        block_rows=BLOCK_ROWS, interpret=True))
    a, _ = hw_packed_pairs.pack_state(state_from_numpy(s))
    got = hw_packed_pairs.pull_packed(a, T(uids), tp).numpy()
    assert got.shape == (1 + K, U)
    # exact on the valid lanes: a gather through a HIGHEST-precision
    # one-hot matmul there, plain indexing here. The Pallas output is
    # undefined on the other lanes; the port writes 0
    assert np.array_equal(got[:, valid], ref[:, valid])
    assert np.all(got[:, ~valid] == 0.0)
    assert np.array_equal(
        got, pair_sweep.pull_pairs(state_from_numpy(s), T(uids), tp).numpy())


@pytest.mark.parametrize("stage", ["pull", "readonly", "loads"])
def test_pull_packed_stage_words_on_the_cpu(stage):
    """The packed pull's stage words on the CPU: ``pull`` is the pull,
    the floor ``readonly`` (loads alone, nothing stored on the card)
    returns None, any other word raises."""
    rng = np.random.default_rng(235)
    _, tp = _params(V_dim=3)
    s = _state_np(3, rng)
    uids, _ = _sorted_uids(rng)
    a, _ = hw_packed_pairs.pack_state(state_from_numpy(s))
    if stage not in hw_packed_pairs.PULL_PACKED_STAGES:
        with pytest.raises(ValueError, match="stage"):
            hw_packed_pairs.pull_packed(a, T(uids), tp, stage)
        return
    got = hw_packed_pairs.pull_packed(a, T(uids), tp, stage)
    if stage == "readonly":
        assert got is None
    else:
        assert torch.equal(got, hw_packed_pairs.pull_packed_plain(
            a, T(uids), tp))


@pytest.mark.parametrize("K,wupd,vupd,tff", [(4, "ftrl", "adagrad", 0),
                                             (0, "ftrl", "adagrad", 0),
                                             (2, "adagrad", "sgd", 0),
                                             (3, "sgd", "adagrad", 2)])
def test_apply_packed_matches_jax(K, wupd, vupd, tff):
    rng = np.random.default_rng(240 + K)
    jp, tp = _params(V_dim=K, w_updater=wupd, V_updater=vupd,
                     tail_feature_filter=tff)
    s = _state_np(K, rng)
    uids, valid = _sorted_uids(rng)
    pay = _payload(K, valid, rng)
    ref = jps.apply_pairs(_jstate(s), jnp.asarray(uids), jnp.asarray(pay),
                          _meta(uids), jp, block_rows=BLOCK_ROWS,
                          interpret=True)
    a, b = hw_packed_pairs.pack_state(state_from_numpy(s))
    a2, b2 = hw_packed_pairs.apply_packed(a, b, T(uids), T(pay), tp)
    assert a2 is a and b2 is b  # in place on both
    got = state_to_numpy(hw_packed_pairs.unpack_state(a, b))
    for name in LEAVES:
        # atol 1e-5: the Pallas sums run through one-hot matmuls
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# S2 bisect kernels
# ---------------------------------------------------------------------------


def _np_row_sums(sid, pay, n):
    """float64 per-row sums [rows of pay, n] by np.add.at."""
    real = (sid >= 0) & (sid < n)
    acc = np.zeros((pay.shape[0], n), np.float64)
    np.add.at(acc.T, sid[real], pay[:, real].T.astype(np.float64))
    return acc


def _np_ftrl4(acc, w, z, n, c):
    """scripts/bisect_apply.py::kernel4's update (:150-161), in float64."""
    g = acc[0]
    n_new = n + g * g
    sigma = (np.sqrt(n_new) - np.sqrt(n)) / 0.01
    z_new = z + g - sigma * w
    w_new = np.where(np.abs(z_new) <= 1.0, 0.0,
                     -(z_new - np.sign(z_new))
                     / ((1.0 + np.sqrt(n_new)) / 0.01 + 0.1))
    touch = acc[1] != 0
    return (np.where(touch, w_new, w), np.where(touch, z_new, z),
            np.where(touch, n_new, n), c + acc[2])


@pytest.mark.parametrize("variant", ["highest", "default", "scanonly",
                                     "loadonly"])
def test_bisect_w_matches_numpy(variant):
    rng = np.random.default_rng(250)
    sid, pay, ipay = bisect_stream(rng)
    w = rng.normal(size=N).astype(np.float32)
    got = bisect_apply.bisect_w(T(sid), T(pay), T(w), variant).numpy()
    if variant in ("scanonly", "loadonly"):
        # the stage variants compute nothing a caller could name
        assert np.array_equal(got, w)
        return
    # float32 sums of runs of up to ~90 unit normals against float64:
    # (n-1) * 2^-24 * sum|x| stays below 1e-4 here
    want = w.astype(np.float64) + _np_row_sums(sid, pay[:1], N)[0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # integers sum exactly in float32
    iw = np.round(w * 4).astype(np.float32)
    got = bisect_apply.bisect_w(T(sid), T(ipay), T(iw), variant).numpy()
    assert np.array_equal(got, iw + _np_row_sums(sid, ipay[:1], N)[0])


@pytest.mark.parametrize("inplace", [False, True])
def test_bisect_ftrl4_matches_numpy(inplace):
    rng = np.random.default_rng(251)
    sid, pay, ipay = bisect_stream(rng)
    s = _state_np(0, rng)
    leaves = [s[k] for k in ("w", "z", "n", "cnt")]
    mine = [T(a.copy()) for a in leaves]
    got = bisect_apply.bisect_ftrl4(T(sid), T(pay), *mine, inplace=inplace)
    want = _np_ftrl4(_np_row_sums(sid, pay[:3], N),
                     *(a.astype(np.float64) for a in leaves))
    for x, y, m, orig in zip(got, want, mine, leaves):
        # float32 against float64 through sqrt and a division by ~100:
        # rtol 1e-4 on values of order 1, atol 1e-5 at the l1 threshold
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4, atol=1e-5)
        assert (x is m) == inplace
        if not inplace:
            assert np.array_equal(m.numpy(), orig)  # inputs untouched
    # an integer payload on a zero state: n = g^2 and the count are exact
    zero = [torch.zeros(N) for _ in range(4)]
    got = bisect_apply.bisect_ftrl4(T(sid), T(ipay), *zero, inplace=inplace)
    acc = _np_row_sums(sid, ipay[:3], N)
    assert np.array_equal(got[2].numpy(), acc[0] * acc[0])
    assert np.array_equal(got[3].numpy(), acc[2])


def _jax_bisect(kernel, n_state, sid, pay, state, br):
    """``scripts/bisect_apply.py``'s Pallas kernel body through
    ``pl.pallas_call(interpret=True)`` with the script's grid (its own
    calls are fixed at N = 2^20 and take no interpret flag)."""
    n, u = state[0].shape[0], sid.shape[0]
    pad = jbisect.G + (-u) % jbisect.G
    sid_p = jnp.asarray(np.concatenate([sid, np.full(pad, n, np.int32)]))
    pay_p = jnp.asarray(np.pad(pay, ((0, 0), (0, pad))))
    nb = n // br
    off = jnp.asarray(np.searchsorted(sid, np.arange(nb + 1) * br)
                      .astype(np.int32))[None, :]
    bs = pl.BlockSpec((br,), lambda i, off: (i,))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(nb,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)] + [bs] * n_state,
        out_specs=bs if n_state == 1 else (bs,) * n_state,
        scratch_shapes=[
            pltpu.VMEM((jbisect.G,), jnp.int32),
            pltpu.VMEM((jbisect.PP, jbisect.G), jnp.float32),
            pltpu.SemaphoreType.DMA, pltpu.SemaphoreType.DMA,
            pltpu.VMEM((jbisect.PP, br), jnp.float32)])
    shape = jax.ShapeDtypeStruct((n,), jnp.float32)
    f = pl.pallas_call(
        functools.partial(kernel, block_rows=br, variant="highest"),
        grid_spec=grid_spec,
        out_shape=shape if n_state == 1 else (shape,) * n_state,
        interpret=True)
    return f(off, sid_p, pay_p, *(jnp.asarray(a) for a in state))


@pytest.mark.parametrize("br", [1024, 512])
def test_bisect_w_matches_the_jax_kernel_in_interpret_mode(br):
    """JAX's interpret mode does run the script's kernel on the CPU (its
    async copies and DMA semaphores included), so this is a comparison
    with the Pallas kernel itself: unique sorted ids, as the script
    makes them."""
    rng = np.random.default_rng(252)
    sid = np.sort(rng.choice(N, size=300, replace=False)).astype(np.int32)
    pay = rng.normal(size=(jbisect.PP, 300)).astype(np.float32)
    w = rng.normal(size=N).astype(np.float32)
    ref = np.asarray(_jax_bisect(jbisect.kernel, 1, sid, pay, [w], br))
    got = bisect_apply.bisect_w(T(sid), T(pay), T(w), block_rows=br).numpy()
    # one slot per row: w + pay through a HIGHEST one-hot matmul there
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_bisect_ftrl4_matches_the_jax_kernel_in_interpret_mode():
    rng = np.random.default_rng(253)
    sid = np.sort(rng.choice(N, size=300, replace=False)).astype(np.int32)
    pay = rng.normal(size=(jbisect.PP, 300)).astype(np.float32)
    s = _state_np(0, rng)
    leaves = [s[k] for k in ("w", "z", "n", "cnt")]
    ref = _jax_bisect(jbisect.kernel4, 4, sid, pay, leaves, 1024)
    got = bisect_apply.bisect_ftrl4(T(sid), T(pay), *(T(a) for a in leaves))
    for x, y in zip(got, ref):
        # the same float32 formulas in both; atol 1e-5 as the apply tests
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=1e-6)


@pytest.mark.parametrize("br", [1024, 512])
def test_bisect_rowscan_matches_the_jax_kernel_and_numpy(br):
    """``rowscan``, the first design of ``bisect_w`` kept beside the
    sparse one, computes the same function: against the Pallas kernel in
    interpret mode on unique ids (atol 1e-6: one slot per row), against
    the float64 sums on repeated ids (atol 1e-4 as above), and the same
    bits as the ``highest`` word, whose plain version it shares."""
    rng = np.random.default_rng(254)
    sid = np.sort(rng.choice(N, size=300, replace=False)).astype(np.int32)
    pay = rng.normal(size=(jbisect.PP, 300)).astype(np.float32)
    w = rng.normal(size=N).astype(np.float32)
    ref = np.asarray(_jax_bisect(jbisect.kernel, 1, sid, pay, [w], br))
    got = bisect_apply.bisect_w(T(sid), T(pay), T(w), "rowscan", br).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    sid, pay, ipay = bisect_stream(rng)
    got = bisect_apply.bisect_w(T(sid), T(pay), T(w), "rowscan", br)
    want = w.astype(np.float64) + _np_row_sums(sid, pay[:1], N)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(got, bisect_apply.bisect_w(T(sid), T(pay), T(w),
                                                  block_rows=br))
    iw = np.round(w * 4).astype(np.float32)
    got = bisect_apply.bisect_w(T(sid), T(ipay), T(iw), "rowscan", br).numpy()
    assert np.array_equal(got, iw + _np_row_sums(sid, ipay[:1], N)[0])


def test_bisect_rowscan_probe_runs_on_the_cpu(capsys):
    assert bisect_apply.main(["rowscan", "512", "n_log2=10", "u=50"],
                             device="cpu") == 0
    assert "rowscan br=512" in capsys.readouterr().out


def test_bisect_wrappers_refuse_unknown_variants():
    w = torch.zeros(8)
    with pytest.raises(ValueError, match="variant"):
        bisect_apply.bisect_w(torch.zeros(0, dtype=torch.int32),
                              torch.zeros((8, 0)), w, "selonly")
    with pytest.raises(SystemExit, match="selonly"):
        bisect_apply.main(["selonly"], device="cpu")


# ---------------------------------------------------------------------------
# S3 slot accumulate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nslots,rows", [(0, 8), (100, 8), (5000, 64),
                                         (40000, 3)])
def test_slot_accum_matches_numpy(nslots, rows):
    rng = np.random.default_rng(260 + rows)
    sid = np.sort(rng.integers(0, rows, nslots)).astype(np.int32)
    sid[sid == 1] = 2  # a row no slot names
    pay = rng.normal(size=(nslots, 128)).astype(np.float32)
    got = bench_slot_accum.slot_accum(T(sid), T(pay), rows).numpy()
    assert got.shape == (rows, 128)
    want = np.zeros((rows, 128), np.float64)
    np.add.at(want, sid, pay.astype(np.float64))
    seg_n = np.bincount(sid, minlength=rows)[:, None]
    abs_sum = np.zeros((rows, 128), np.float64)
    np.add.at(abs_sum, sid, np.abs(pay).astype(np.float64))
    # any float32 summation order is within (n-1) * 2^-24 * sum|x|
    tol = np.maximum(seg_n - 1, 0) * 2.0 ** -24 * abs_sum
    assert np.all(np.abs(got - want) <= tol)
    assert np.all(got[1] == 0.0)
    # integers in [1, 8] sum exactly in float32
    ipay = rng.integers(1, 9, size=(nslots, 128)).astype(np.float32)
    want = np.zeros((rows, 128), np.float64)
    np.add.at(want, sid, ipay)
    got = bench_slot_accum.slot_accum(T(sid), T(ipay), rows).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the slice as a whole: every probe's entry point
# ---------------------------------------------------------------------------

SMALL = ["batch=256", "nnz=8", "num_bits=12", "k=4"]
PROBES = [
    (hw_apply2, SMALL + ["u=2048", "iters=2"]),
    (hw_packed_pairs, SMALL + ["iters=2"]),
    (bisect_apply, ["highest", "n_log2=12", "u=300"]),
    (bisect_apply, ["default", "512", "n_log2=12", "u=300"]),
    (bisect_apply, ["scanonly", "n_log2=12", "u=300"]),
    (bisect_apply, ["loadonly", "n_log2=12", "u=300"]),
    (bisect_apply, ["ftrl4", "n_log2=12", "u=300"]),
    (bisect_apply, ["ftrl4_inplace", "256", "n_log2=12", "u=300"]),
    (bench_slot_accum, ["12", "rows=64"]),
    (segsum_designs, ["batch=256", "nnz=8", "num_bits=12", "pp=6"]),
]


@pytest.mark.parametrize(
    "probe,argv", PROBES,
    ids=[f"{m.__name__.rsplit('.', 1)[1]}-{a[0]}" for m, a in PROBES])
def test_probe_runs_on_the_cpu(probe, argv, capsys):
    assert probe.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.startswith(probe.__name__.rsplit(".", 1)[1] + " on cpu")
    assert "not measured (cpu)" in out  # a CPU time is no figure of the port
    assert " ms" not in out.replace("not measured (cpu)", "")


@pytest.mark.parametrize("probe", [hw_apply2, hw_packed_pairs, bisect_apply,
                                   bench_slot_accum, segsum_designs],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_needs_a_card_unless_asked_for_cpu(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])


def test_bisect_main4_runs_on_the_cpu(capsys):
    assert bisect_apply.main4(True, 256, device="cpu", n_log2=12, u=300) == 0
    assert "alias=True" in capsys.readouterr().out


def test_probe_options_are_checked():
    with pytest.raises(SystemExit, match="unknown option"):
        hw_apply2.main(["rows=3"], device="cpu")


def test_flagship_uniques_are_sorted_and_sentinel_padded():
    uids, valid = common.flagship_uniques(np.random.default_rng(0), 256, 8,
                                          12, 2048)
    nv = int(valid.sum())
    assert uids.dtype == np.int32 and uids.shape == (2048,)
    assert np.all(np.diff(uids[:nv]) > 0) and np.all(uids[nv:] == 1 << 12)
    assert valid[:nv].all() and not valid[nv:].any()
    # a bucket smaller than the batch's uniques keeps one sentinel lane
    uids, valid = common.flagship_uniques(np.random.default_rng(0), 256, 8,
                                          12, 64)
    assert int(valid.sum()) == 63 and uids[-1] == 1 << 12
