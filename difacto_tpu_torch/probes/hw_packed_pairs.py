"""Probe: a PACKED planar state for the pair kernels.

Counterpart of ``scripts/hw_packed_pairs.py``. The state is held as two
arrays instead of six leaves,

    A [2+K, N] = w | cnt | V      (what the pull reads)
    B [2+K, N] = z | n  | nV      (what only the apply also needs)

and ``pull_packed`` (csrc/packed_pairs.cu) / ``apply_packed``
(csrc/planar_apply.cu's entry, which hands the rows of A and B as leaves
to csrc/apply_pairs.cu's kernel, or by a stage word to the tile design)
compute what ``pull_pairs`` / ``apply_pairs`` compute; the apply is in
place on both. On the TPU the
script asked whether fewer, larger block copies per grid step are
cheaper. A CUDA thread addresses single floats, so the question here is
what the table's layout costs when the accesses stay the same: it is the
first of the layout measurements (the second is
probes/bench_slot_accum.py).

The probe runs one flagship batch (16384 x 40 Zipf(1.2) slots, 2^22 rows,
K = 16) through the port's host prep, times packed against current for
the pull and the apply (and, on the card, the kernels' own times in
turns: both apply designs and the tiles' floor), prints the largest
differences, and returns non-zero above 1e-5, as the script does. The
script starts from a fresh state, whose counts are all below
``V_threshold``; a card's traffic depends on how many rows pass that
gate, so the state here has counts on both sides of it and nonzero
accumulators, made from a seed.

    python -m difacto_tpu_torch.probes.hw_packed_pairs
    python -m difacto_tpu_torch.probes.hw_packed_pairs batch=512 num_bits=13
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import FMParam
from ..data.prep import prep_batch
from ..ops import cuda, pair_sweep
from ..ops.sweep_ms import V_UPDATERS, W_UPDATERS
from ..updaters.updater import LEAVES, FMState
from . import common


def pack_state(state: FMState) -> tuple[torch.Tensor, torch.Tensor]:
    """``(A, B)``, both ``[2+K, N]``: A = w | cnt | V, B = z | n | nV
    (copies)."""
    a = torch.cat([state.w[None], state.cnt[None], state.V], dim=0)
    b = torch.cat([state.z[None], state.n[None], state.nV], dim=0)
    return a, b


def unpack_state(a: torch.Tensor, b: torch.Tensor) -> FMState:
    """The six leaves as VIEWS of the rows of A and B: an in-place update
    of the returned state updates A and B."""
    return FMState(w=a[0], z=b[0], n=b[1], V=a[2:], nV=b[2:], cnt=a[1])


def pull_packed_plain(a: torch.Tensor, uids: torch.Tensor,
                      param: FMParam) -> torch.Tensor:
    """Indexing plus a mask over the rows of A."""
    n = a.shape[1]
    keep = (uids >= 0) & (uids < n)
    rows = a[:, torch.where(keep, uids, 0).long()]
    out = torch.empty((a.shape[0] - 1, uids.shape[0]), dtype=torch.float32,
                      device=a.device)
    out[0] = torch.where(keep, rows[0], 0.0)
    act = keep & (rows[1] >= float(param.V_threshold))
    out[1:] = torch.where(act[None, :], rows[2:], 0.0)
    return out


# The pull's stage words, flags of csrc/packed_pairs.cu's C entry: ``pull``
# the kernel; ``readonly`` its floor, the same loads and no stores.
PULL_PACKED_STAGES = {"pull": 0, "readonly": 1}


def pull_packed(a: torch.Tensor, uids: torch.Tensor, param: FMParam,
                stage: str = "pull") -> torch.Tensor | None:
    """``pull_pairs`` over the packed A: rows [1+K, U] for sorted unique
    ``uids`` (i32, sentinel ``N`` pads); row 0 is w, rows 1..K are V gated
    by ``cnt >= V_threshold``; sentinel lanes are 0 (undefined in the TPU
    script's output). ``stage="readonly"`` launches the kernel's floor,
    which issues the pull's loads and stores nothing, and returns None
    (on the CPU it does nothing)."""
    if stage not in PULL_PACKED_STAGES:
        raise ValueError(f"stage {stage!r} not in "
                         f"{sorted(PULL_PACKED_STAGES)}")
    if uids.device.type == "cpu":
        if stage == "readonly":
            return None
        return pull_packed_plain(a, uids, param)
    dev = a.device
    k, n, u = a.shape[0] - 2, a.shape[1], uids.shape[0]
    cuda.require(a, "A", torch.float32, (2 + k, n), dev)
    cuda.require(uids, "uids", torch.int32, (u,), dev)
    out = torch.empty((1 + k, u), dtype=torch.float32, device=dev)
    rc = cuda.library().dft_pull_packed(
        a.data_ptr(), uids.data_ptr(), out.data_ptr(), n, k, u,
        float(param.V_threshold), PULL_PACKED_STAGES[stage],
        cuda.stream(dev))
    cuda.check(rc, "pull_packed")
    cuda.LAUNCHES["pull_packed"] += 1
    return None if stage == "readonly" else out


def apply_packed_plain(a, b, uids, payload, param: FMParam):
    """``apply_pairs_plain`` on the row views of A and B, in place."""
    pair_sweep.apply_pairs_plain(unpack_state(a, b), uids, payload, param)
    return a, b


def apply_packed(a: torch.Tensor, b: torch.Tensor, uids: torch.Tensor,
                 payload: torch.Tensor, param: FMParam, stage: str = "lanes"):
    """``apply_pairs`` over the packed A and B, IN PLACE on both (the TPU
    script's ``input_output_aliases``): payload ``[3+K, U]`` gw | gV |
    add_cnt | touch over non-decreasing ``uids``. ``stage`` names the
    design as for ``pair_sweep.apply_pairs2``
    (``pair_sweep.PLANAR_APPLY_STAGES``): ``lanes``, the default, is
    csrc/apply_pairs.cu's kernel on the rows of A and B, ``tiles`` the
    tile design; the floor ``rmwonly`` leaves A and B as they were.
    Returns ``(A, B)``."""
    flags = pair_sweep.planar_apply_flags(stage)
    if uids.device.type == "cpu":
        if stage == "rmwonly":
            return a, b
        return apply_packed_plain(a, b, uids, payload, param)
    dev = a.device
    k, n, u = a.shape[0] - 2, a.shape[1], uids.shape[0]
    cuda.require(a, "A", torch.float32, (2 + k, n), dev)
    cuda.require(b, "B", torch.float32, (2 + k, n), dev)
    cuda.require(uids, "uids", torch.int32, (u,), dev)
    cuda.require(payload, "payload", torch.float32, (3 + k, u), dev)
    if u > 1:
        torch._assert_async(torch.all(uids[1:] >= uids[:-1]),
                            "apply_packed: uids must be non-decreasing")
    p = param
    rc = cuda.library().dft_apply_packed(
        a.data_ptr(), b.data_ptr(), uids.data_ptr(), payload.data_ptr(),
        n, k, u, p.lr_eta, p.lr_beta, p.l1, p.l2, p.V_lr_eta, p.V_lr_beta,
        p.V_l2, float(p.V_threshold), int(p.tail_feature_filter),
        W_UPDATERS[p.w_updater], V_UPDATERS[p.V_updater], flags,
        cuda.stream(dev))
    cuda.check(rc, "apply_packed")
    cuda.LAUNCHES["apply_packed"] += 1
    return a, b


def trained_state(n: int, k: int, rng, dev) -> FMState:
    """A trained-looking planar state from numpy: counts on both sides of
    the V threshold, nonzero optimizer accumulators."""
    f32 = np.float32
    leaves = dict(
        w=rng.normal(0, 0.1, n).astype(f32), z=rng.normal(size=n).astype(f32),
        n=rng.random(n).astype(f32),
        V=rng.uniform(-0.01, 0.01, (k, n)).astype(f32),
        nV=rng.random((k, n)).astype(f32),
        cnt=rng.integers(0, 4, n).astype(f32))
    return FMState(**{name: torch.from_numpy(v).to(dev)
                      for name, v in leaves.items()})


def main(argv=None, device=None) -> int:
    _, o = common.parse_args(argv, dict(
        batch=common.BATCH, nnz=common.NNZ, num_bits=common.NUM_BITS,
        k=common.K, iters=30))
    dev = common.start("hw_packed_pairs", device)
    n, k = 1 << o["num_bits"], o["k"]
    p = FMParam()
    p.V_dim = k
    pb = prep_batch(common.flagship_batch(0, o["batch"], o["nnz"],
                                          o["num_bits"]), n)
    uids = torch.from_numpy(pb.uids).to(dev)
    u = uids.shape[0]
    rng = np.random.default_rng(0)
    state = trained_state(n, k, rng, dev)
    a, b = pack_state(state)
    print(f"U={u} ({int(pb.valid.sum())} real ids) packed rows={2 + k} "
          f"table 2^{o['num_bits']} rows", flush=True)

    # -- pull: exact (a gather with a mask) -------------------------------
    err_p = float((pull_packed(a, uids, p)
                   - pair_sweep.pull_pairs(state, uids, p)).abs().max())
    t_pp = common.time_ms(lambda: pull_packed(a, uids, p), dev, o["iters"])
    t_p0 = common.time_ms(lambda: pair_sweep.pull_pairs(state, uids, p), dev,
                          o["iters"])

    # -- apply: one application each from the same state ------------------
    payl = (rng.normal(size=(3 + k, u)) * 0.01).astype(np.float32)
    payl[2 + k] = (rng.random(u) > 0.3).astype(np.float32)  # touch
    payl[1 + k] = np.abs(payl[1 + k])                       # add_cnt
    pay = torch.from_numpy(payl).to(dev)
    a2, b2 = apply_packed(a.clone(), b.clone(), uids, pay, p)
    s2 = pair_sweep.apply_pairs(
        FMState(**{name: getattr(state, name).clone() for name in LEAVES}),
        uids, pay, p)
    packed = unpack_state(a2, b2)
    err_a = max(float((getattr(packed, name) - getattr(s2, name)).abs().max())
                for name in LEAVES if getattr(s2, name).numel())
    a3, b3 = apply_packed(a2.clone(), b2.clone(), uids, pay, p, "rmwonly")
    kept = torch.equal(a3, a2) and torch.equal(b3, b2)
    t_ap = common.time_ms(lambda: apply_packed(a2, b2, uids, pay, p), dev,
                          o["iters"])
    t_a0 = common.time_ms(lambda: pair_sweep.apply_pairs(s2, uids, pay, p),
                          dev, o["iters"])

    f = common.fmt_ms
    print(f"pull  packed: {f(t_pp)}   current: {f(t_p0)}   "
          f"max|err| {err_p:.2e}")
    print(f"apply packed: {f(t_ap)}   current: {f(t_a0)}   "
          f"max|err| {err_a:.2e}; rmwonly kept A and B: {kept}", flush=True)
    if dev.type == "cuda":
        calls = {
            "pull packed": lambda: pull_packed(a, uids, p),
            "pull packed readonly": lambda: pull_packed(a, uids, p,
                                                        "readonly"),
            "pull current": lambda: pair_sweep.pull_pairs(state, uids, p),
            "apply current": lambda: pair_sweep.apply_pairs(s2, uids, pay,
                                                            p)}
        for stage in pair_sweep.PLANAR_APPLY_STAGES:
            floor = stage == "rmwonly"
            calls[f"apply packed {stage}"] = lambda stage=stage, floor=floor: (
                apply_packed(a3 if floor else a2, b3 if floor else b2, uids,
                             pay, p, stage))
        own = common.kernel_ms_in_turns(dev, calls, (
            "pull_packed_kernel", "pull_pairs_kernel", "apply_pairs_kernel",
            "planar_apply_kernel"))
        print(f"kernel ms in turns: {own}", flush=True)
    return 0 if max(err_p, err_a) < 1e-5 and kept else 1

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
