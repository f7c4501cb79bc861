"""K1's merge: the stable merge of the sharded store owner's S sorted
segments (``pair_sweep.merge_segments``, csrc/seg_merge.cu on the card)
and the plain version of K1 restated on it.

On the CPU the wrappers run their plain versions: the merge is held
exactly against NumPy's stable argsort, K1's plain version against the
bits of its body before the restatement, and against the JAX package's
``apply_pairs`` in interpret mode walking a ``build_pair_meta(...,
seg_len=C)`` schedule, at B2's tolerance (rtol 1e-5, atol 1e-6, as
tests/test_torch_sharded.py::test_k1_plain_matches_jax). The streams:
S = 1 to 4 segments with ids repeated within and across segments, an
all-sentinel segment, a segment with no sentinel, and owner 0's receive
stream of a small Zipf batch prepped by ``prep_batch_sharded`` (as
chip_smoke.py's ``k1_stream`` builds it at the flagship's shape).
tests/test_torch_cuda.py holds the kernel against this plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.config import FMParam as JFMParam
from difacto_tpu.ops import pair_sweep as jps
from difacto_tpu.updaters.updater import FMState as JFMState
from difacto_tpu_torch.ops import pair_sweep
from difacto_tpu_torch.updaters.updater import pack_state
from difacto_tpu_torch.utils.checkpoint import state_from_numpy, state_to_numpy
from test_torch_cuda import (K1_CASES as CASES, LEAVES, k1_case, port_params,
                             seg_payload, state_np)

torch.set_num_threads(2)

T = torch.from_numpy
def old_segs_plain(state, uids, payload, param, seg_len):
    """K1's plain version as it was written before the merge: a stable
    sort of the ids, then the one-stream plain apply."""
    pair_sweep._segments(uids, seg_len)
    order = torch.sort(uids, stable=True).indices
    return pair_sweep.apply_pairs_plain(state, uids[order],
                                        payload[:, order], param)


@pytest.mark.parametrize("case", CASES)
def test_merge_plain_matches_stable_argsort(case):
    """The merged ids and the payload's columns are those of NumPy's
    stable argsort, exactly: non-decreasing, ties by segment, then lane,
    every sentinel at the tail. The case holds what its name says."""
    uids, valid, C, n = k1_case(case, 500 + CASES.index(case))
    S = uids.shape[0] // C
    segs = uids.reshape(S, C)
    assert np.all(np.diff(segs, axis=1) >= 0)
    if case == "all_sentinel":
        assert np.all(segs[1] == n)
    if case == "no_sentinel":
        assert np.all(segs[0] < n)
    if S > 1:  # ids repeat across segments
        assert len(np.intersect1d(segs[0][segs[0] < n],
                                  segs[-1][segs[-1] < n])) > 0
    if not case.startswith("prep_s"):  # and within one (a prep's are unique)
        assert np.any(np.diff(segs[0][segs[0] < n]) == 0)
    pay = seg_payload(3, valid, np.random.default_rng(7))
    pay[:, ~valid] = np.arange((~valid).sum())  # sentinel lanes tell apart
    mu, mp = pair_sweep.merge_segments(T(uids), T(pay), C)
    order = np.argsort(uids, kind="stable")
    assert torch.equal(mu, T(uids[order]))
    assert torch.equal(mp, T(pay[:, order]))
    real = int(valid.sum())
    assert torch.all(mu[:real] < n) and torch.all(mu[real:] == n)


@pytest.mark.parametrize("layout", ["planar", "packed"])
@pytest.mark.parametrize("case", CASES)
def test_k1_plain_keeps_todays_bits(case, layout):
    """K1's plain version restated as the plain merge then the one-stream
    plain apply gives the bits of its former body, on either layout,
    through ``apply_pairs(..., seg_len=C)`` and the search design's
    wrapper on CPU tensors alike; a segment length that does not divide
    the stream raises."""
    uids, valid, C, n = k1_case(case, 600 + CASES.index(case))
    K = 3
    p = port_params(V_dim=K, w_updater="ftrl", V_updater="adagrad",
                    tail_feature_filter=2 if layout == "packed" else 0)
    s = state_np(K, np.random.default_rng(8), n=n)
    pay = T(seg_payload(K, valid, np.random.default_rng(9)))

    def fresh():
        st = state_from_numpy(s)
        return pack_state(st) if layout == "packed" else st

    ref = state_to_numpy(old_segs_plain(fresh(), T(uids), pay, p, C))
    for fn in (pair_sweep.apply_pairs_segs_plain,
               lambda *a: pair_sweep.apply_pairs(*a[:4], seg_len=a[4]),
               pair_sweep.apply_pairs_segs_search):
        got = state_to_numpy(fn(fresh(), T(uids), pay, p, C))
        for leaf in LEAVES:
            assert np.array_equal(got[leaf].view(np.int32),
                                  ref[leaf].view(np.int32)), leaf
    with pytest.raises(ValueError, match="does not divide"):
        pair_sweep.merge_segments(T(uids), pay, C + 1)


@pytest.mark.parametrize("case", CASES)
def test_k1_plain_matches_jax_on_merge_cases(case):
    """The restated plain route against the JAX apply_pairs in interpret
    mode over a ``build_pair_meta(..., seg_len=C)`` schedule of the same
    stream; B2's tolerance (rtol 1e-5, atol 1e-6)."""
    uids, valid, C, n = k1_case(case, 700 + CASES.index(case))
    K = 4
    tp = port_params(V_dim=K, w_updater="ftrl", V_updater="adagrad")
    jp = JFMParam()
    for f in ("V_dim", "w_updater", "V_updater", "tail_feature_filter",
              "V_threshold", "l1", "lr_eta"):
        setattr(jp, f, getattr(tp, f))
    s = state_np(K, np.random.default_rng(10), n=n)
    pay = seg_payload(K, valid, np.random.default_rng(11))
    m = jps.build_pair_meta(uids, n, 512, seg_len=C)
    ref = jps.apply_pairs(
        JFMState(**{k: jnp.asarray(v) for k, v in s.items()}),
        jnp.asarray(uids), jnp.asarray(pay),
        tuple(jnp.asarray(x) for x in (m.blocks, m.wins, m.first, m.wfirst)),
        jp, block_rows=512, interpret=True)
    got = state_to_numpy(pair_sweep.apply_pairs(state_from_numpy(s), T(uids),
                                                T(pay), tp, seg_len=C))
    for leaf in LEAVES:
        np.testing.assert_allclose(got[leaf], np.asarray(getattr(ref, leaf)),
                                   rtol=1e-5, atol=1e-6, err_msg=leaf)
