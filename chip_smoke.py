"""Smoke run of the PyTorch port (difacto_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each a hard failure:

1. build the hand-written CUDA kernels from ``difacto_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card at the
   flagship shapes (batch 16384 x 40 nnz with Zipf(1.2) ids, 2^22 rows,
   K = 16; the sweep kernels with 1024-row blocks, one stream, two
   streams of repeated ids whose integer payload must sum exactly, and a
   dense block; the probes' kernels at their probes' shapes; the planar
   apply of csrc/planar_apply.cu, B6 ``apply_pairs2`` and S1b
   ``apply_packed`` by both designs (``lanes``, B2's kernel, and
   ``tiles``), also bit for bit against ``apply_pairs``, the tiles'
   ``rmwonly`` floor leaving the state's bits, and all timed in turns
   with B2, warm and flushed, beside the byte bound and the sector floor;
   the kernels over the
   row-major table, pairs and sweep, against their plain versions and,
   bit for bit, against the planar kernels, timed in turns with them,
   L2 warm and flushed; the segment sum's three designs against the
   float64 sums, exactly on integers and bit for bit on a second run,
   timed in turns), and time the kernel, the plain version and, where one
   PyTorch call computes the same function, that call;
3. hold the device train and eval steps of every table path (pairs and
   the whole-table sweep, each over the planar and over the row-major
   table, with the sorted and the scatter backward; ``kernel=xla`` over
   the stacked, planar and row-major tables with either backward; the
   hot/cold split at a small table; device localize, ``host_localize=0``,
   on ``xla`` and on the sweeps, and with a ``unique_size`` that drops
   ids) against the CPU plain path on a small batch, from one state, and
   the hot/cold split against the stacked table on the card;
4. drive the flagship through ``SGDLearner`` eight times (``MAIN_PATHS``):
   on the pair kernels (``kernel=auto`` with ``layout=planar`` and with
   ``layout=packed``), on the whole-table sweep (``kernel=pallas``
   over planar leaves and over the row-major table, which is what its
   default layout resolves to, each with the scatter and with the sorted
   backward), on ``kernel=xla`` (the stacked table, FM's fused per-key
   sums) and on
   ``host_localize=0 kernel=pallas`` (the row-major sweeps over ids
   localized on the card): an epoch that
   streams from a libsvm file and caches the batches on the card, then a
   timed epoch that replays them, a traced replay and a validation pass,
   with every launch counter reset just before each drive and read just
   after; the sweep's two layouts must report the same metrics;
5. the CLI on a small synthetic set, on the four table paths: train 2
   epochs with validation and ``model_out``, then ``task=predict`` on that
   checkpoint, whose AUC must pass 0.6 and whose scores must match the
   CPU's;
6. run the five kernel probes (``difacto_tpu_torch/probes``) in process
   at their full shapes; each must return 0 and launch its kernels.

FFM (``loss=ffm``) at BASELINE config 5's width (``examples/ffm.conf``:
batch 4096 x 24 slots, the slot position as field, k = 4, so K = F*k = 96
factors a feature, 2^22 rows) runs through the same phases: the checks of
the row-major kernels, pairs and sweep, and of B3's designs run again at
its width (K = 96, B3 on 97 payload rows), against their plain versions
and the planar kernels and timed in turns; ``ffm_loss_grad`` on the card
against the CPU; its train and eval steps on every table path against
the CPU; two more main paths through ``SGDLearner`` (``FFM_PATHS``:
``kernel=auto``, which resolves to the row-major table, and
``layout=planar``); and CLI train + ``task=predict``. The packed pull S1a
is timed in turns with its floor ``readonly`` (its loads alone) and B1,
beside the sector floor of the run's data.

The repo's data formats at full width (``drive_formats``): P1
``examples/fm_criteo.conf`` as written (csr parts made from the flagship
text by the port's converter; its epoch-0 stream time beside the text's,
parsed by the native parser), then CLI train + ``task=predict`` on the
parts; P2 Criteo in libffm form (39 explicit fields shuffled within each
row, k = 4, K = 156, ``examples/ffm.conf``'s updater settings) on
``kernel=auto`` and ``layout=planar``, its steps against the CPU, CLI
train + ``task=predict`` on the libffm files; P3 P1 on
``examples/northstar.conf``'s config-4 table (2^26 rows), whose prep must
take the native radix localizer, timed against NumPy's searchsorted on
one batch (host CPU times); P4 ``examples/northstar.conf`` with its
config-4 settings (``num_bits=26 hot_rows=-1 cache_compact=1``) on
northstar-shaped csr parts (39 fields of 60,000 values), beside the same
keys with ``cache_compact=0`` (the full batch cache: the same table bits,
the cached bytes of both forms logged), ``hot_rows=0 kernel=xla`` and
``kernel=auto``: every batch of the split runs split, FM's fused per-key
sums on every step.
Phase 3 also holds the compact cache at the flagship's shape on
``kernel=auto`` (``check_compact_step``). The kernel checks of the flagship's width run
again at K = 156 on a libffm batch and at K = 640 (FFM, 40 slots of
k = 16, 2^16 rows: the row-major kernels past one shared-memory tile),
with the train and eval steps at K = 640 against the CPU. The native
host engines must build (g++).

Three phases drive the rest of the JAX package's one-card surface. P5
``examples/bcd_linear.conf`` as written (the BCD learner: num_bits=22,
batch 8192, V_dim=0, l1=1, l2=0.1, 5 epochs, 256 blocks) on 2^20
northstar-shaped rows in csr parts (``data_format=csr``, the data paths,
``model_out`` and ``bcd_tile_dir`` set): the disk tile store must hold
every triplet, the block step on the card match the CPU's on three blocks
from one state, the run learn (train logloss falls, validation AUC above
0.6, nonzero w), a 2^14-row run match the CPU's w, and CLI train plus
``task=predict`` on its checkpoint launch B1 at K = 0 and nothing else,
with the CPU's scores; a sweep of the blocks timed and traced. P6 the
flagship's CLI train and ``task=predict`` on ``kernel=auto`` with every
URI on ``memory://`` (libsvm text in two byte-range parts, gzip
validation text, the checkpoint, the scores), equal bit for bit to the
same run on local files, and a BCD tile build from ``memory://`` csr parts
equal byte for byte to the local one. P7 ``DIFACTO_PROFILE``: the
flagship's first train epoch through ``SGDLearner`` writes one
``torch.profiler`` trace naming the kernels it launched, the second none;
then ``dump_model`` and ``table_stats`` on P5's and P1's checkpoints.

K1, B2 over the sharded store owner's receive stream (S sorted segments
of C lanes, ids repeated across them; ``apply_pairs(..., seg_len=C)``:
the stable merge ``merge_segments`` (csrc/seg_merge.cu), then the
one-stream apply on the merged stream, counted as ``apply_pairs_segs`` on
planar leaves and ``apply_rowmajor_segs`` on the row-major table), is
held in phase 2 at the flagship's width on owner 0's stream of a flagship
batch over S = 2 and 4 sources (``check_k1_kernels``: the merge exact
against its plain version, K1 against its plain version at B2's
tolerance and bit for bit against the search design, the yardstick
``apply_pairs_segs_search``, timed in turns with it, warm and flushed;
exact integer sums, the one-stream bits on disjoint segments); P8 and
P9 must launch one merge a K1 call and never the search design. P8
drives the sharded store
(``store=sharded``, ``drive_sharded``): (a) the flagship's CLI train and
``task=predict`` at S = 1 on kernel=auto, bit for bit against
``store=local``; (b) S = 2 and S = 3 gloo ranks sharing the card
(``difacto_tpu_torch.parallel.launch``, each under a timeout; at S = 3
the flagship batch gains two empty rows so that 3 divides it), each
taking 8 prepped train steps, an eval and a count step on the flagship's
global batches on kernel=auto (K1 on the row-major table), layout=planar
(K1 on planar leaves) and kernel=pallas (B5), the gathered table, the
metrics and the scores held in rank 0 against LocalStore on the card
(the JAX package's local-against-sharded tolerance), with the step ms,
the busy ms, the idle share and the all_to_all's share of the step.

P9 drives the multi-process learner (``drive_multiprocess``): the CLI's
``main`` as P processes under the env contract
(``DIFACTO_COORDINATOR``/``NUM_PROCESSES``/``PROCESS_ID``, a free port,
``run_processes``, each launch under a timeout that kills every process
left), sharing the card, on P6's flagship text in byte-range parts, 8
global batches of 16384, 3 epochs, one validation batch: (a) P = 2 on
kernel=auto, (c) P = 3 at a global batch of 16386, (d) P = 2 on
layout=planar, each held against LocalStore on the card fed the same
global stream (the per-process checkpoint by the port's ``load_full``,
rtol and atol 2e-4; the validation logloss rel 1e-5 and exact AUC abs
1e-5, the same on every process; (a) and (d) pad a step); (b) P = 2
``task=predict`` on (a)'s checkpoint, its part files against a
one-process predict of the file set, B1 alone; (e) P = 2 BCD on
``examples/bcd_linear.conf`` over 2^18 of P5's rows, w against one
process on the card. Each run prints rank 0's epoch s and step ms (the
one-process CLI's beside them), the shares of the timed epoch taken by
the all_to_alls and the host allgathers (BCD: the all_reduce), the busy
ms and idle share of rank 0's traced last epoch, and each process's wall
s (``P9Probe``).

It prints the card's name and power limit, one JSON line listing the
kernels with their numbers, and last ``{"ok": true, "device": ...}``. It
needs a card: without one (or without the rest of the repository) it
exits non-zero and prints no result. It imports nothing of JAX.
``python3 chip_smoke.py --kernels-only`` stops after phase 2 and prints
no result line: a short first run for a new kernel.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH, NNZ, NUM_BITS, K = 16384, 40, 22, 16
BLOCK_ROWS = 1024         # table block of the sweep kernels (the default)
MAIN_BATCHES = 8          # batches in the main-path file (one epoch)
FM_CELL_BATCH = 131072    # rows a step of the fmbench FM cells
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
REPS = 20
# the kernels of the two table paths, each path's pull first. FM (K > 0)
# takes the fused per-key sums (segsum_fm), FFM B3 (segsum_sorted) over
# its gathered gradient rows
PAIRS_KERNELS = ("pull_pairs", "segsum_fm", "apply_pairs")
ROWMAJOR_KERNELS = ("pull_rowmajor", "segsum_fm", "apply_rowmajor")
FFM_PAIRS_KERNELS = ("pull_pairs", "segsum_sorted", "apply_pairs")
FFM_ROWMAJOR_KERNELS = ("pull_rowmajor", "segsum_sorted", "apply_rowmajor")
SWEEP_KERNELS = ("sweep_pull", "sweep_apply")
SWEEP_SORTED_KERNELS = ("sweep_pull", "segsum_fm", "sweep_apply")
SWEEP_ROWMAJOR_KERNELS = ("sweep_pull_rowmajor", "sweep_apply_rowmajor")
SWEEP_ROWMAJOR_SORTED_KERNELS = ("sweep_pull_rowmajor", "segsum_fm",
                                 "sweep_apply_rowmajor")
# kernel=xla: gathers and scatter-adds of tensor ops around FM's sums
XLA_KERNELS = ("segsum_fm",)
# every table path's kernels: a drive launches none of them off its path
TABLE_KERNELS = frozenset(PAIRS_KERNELS + ROWMAJOR_KERNELS + SWEEP_KERNELS
                          + SWEEP_ROWMAJOR_KERNELS + FFM_PAIRS_KERNELS)
PULL_KERNELS = ("pull_pairs", "pull_rowmajor", "sweep_pull",
                "sweep_pull_rowmajor")
# the kernels whose launches on the paths of the XLA table, device
# localize, P4, P5's predict, P6, P7 and P8 the kernels line also gives
NEW_PATH_KERNELS = ("pull_pairs", "segsum_fm", "sweep_pull",
                    "sweep_apply", "sweep_pull_rowmajor",
                    "sweep_apply_rowmajor", "pull_rowmajor", "apply_rowmajor")
UPDATER_CASES = ((K, "ftrl", "adagrad"), (K, "adagrad", "sgd"),
                 (K, "sgd", "adagrad"), (0, "ftrl", "adagrad"))
# BASELINE config 5 (examples/ffm.conf, scripts/hw_ffm_sorted.py:37-49):
# FFM with the slot position as field, F = 24 fields of k = 4 factors
FFM_BATCH, FFM_NNZ, FFM_K = 4096, 24, 4
FFM_WIDTH = FFM_NNZ * FFM_K  # K = F*k = 96 factors a feature
# Criteo in libffm form as the libffm authors publish it (Juan et al.,
# "Field-aware Factorization Machines for CTR Prediction", RecSys 2016):
# 39 fields of k = 4, explicit field ids shuffled within each row
LIBFFM_BATCH, LIBFFM_FIELDS, LIBFFM_K = 4096, 39, 4
LIBFFM_WIDTH = LIBFFM_FIELDS * LIBFFM_K  # K = 156, a 157-row payload
# the width past one shared-memory tile of the row-major kernels: FFM with
# the slot position as field, 40 slots of k = 16 (K = 640), on a small
# batch and table
WIDE_BATCH, WIDE_NNZ, WIDE_KF, WIDE_BITS = 512, 40, 16, 16
WIDE_WIDTH = WIDE_NNZ * WIDE_KF
# the repo's example configs whose data formats the paths read
CRITEO_CONF = "examples/fm_criteo.conf"   # csr parts, BASELINE config 3
FFM_CONF = "examples/ffm.conf"            # its updater settings for libffm
BIG_BITS = 26  # examples/northstar.conf's config-4 table


def log(msg: str) -> None:
    print(msg, flush=True)


def flagship_batch(seed: int):
    from difacto_tpu_torch.probes import common

    return common.flagship_batch(seed, BATCH, NNZ, NUM_BITS)


def cuda_ms(fn, reps: int = REPS) -> float:
    from difacto_tpu_torch.probes import common

    return common.cuda_ms(fn, reps)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f64_sum_tolerance(n_terms, abs_sum):
    """Any float32 summation order is within (n-1) u sum|x| of the exact
    sum of n terms (u = 2^-24)."""
    return (n_terms - 1).clamp(min=0) * 2.0 ** -24 * abs_sum


def random_state(updater, num_rows, dev, seed):
    """A trained-looking state made on the card from a seed: counts on
    both sides of the V threshold, nonzero optimizer accumulators."""
    import torch

    st = updater.init_state(num_rows, seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    st.w.normal_(0.0, 0.1, generator=g)
    st.z.normal_(0.0, 1.0, generator=g)
    st.n.uniform_(0.0, 1.0, generator=g)
    st.cnt.copy_(torch.randint(0, 4, (num_rows,), generator=g, device=dev))
    st.nV.uniform_(0.0, 1.0, generator=g)
    return st


def clone_state(st):
    from difacto_tpu_torch.updaters.updater import FMState

    return FMState(**{k: getattr(st, k).clone() for k in
                      ("w", "z", "n", "V", "nV", "cnt")})


def past_gate(pb, state, q) -> int:
    """How many of the batch's unique ids are past the V gate."""
    idx = pb.uids.clamp(max=state.num_rows - 1).long()
    return int((pb.valid & (state.cnt[idx] >= q.V_threshold)).sum())


def updater_bytes(wupd: str, vupd: str, k: int, n_rows: int, n_act: int):
    """Bytes an apply reads and writes in the table: per row it updates,
    the leaves its updaters use (+ cnt), and V/nV only on the rows past
    the V gate."""
    wl = {"ftrl": 3, "adagrad": 2, "sgd": 1}[wupd] + 1
    vl = {"adagrad": 2, "sgd": 1}[vupd] * k
    return 4 * 2 * (wl * n_rows + vl * n_act)


def in_turns(dev, first, second, names):
    """(first ms, second ms) by CUDA events over the wrapper calls, each
    the mean of two timings taken in the order first, second, second,
    first; and each one's own kernel time from torch.profiler, taken in
    the same order (the sum over the kernels whose name contains one of
    ``names``), which for kernels this short is the better figure (the
    event time is the host's enqueue rate, and a planar apply's wrapper
    also launches an order check): {"warm": [second, first], "cold":
    [...]} in ms, warm as the event loop runs them (the same rows every
    call, so they sit in the L2), cold after a write of 256 MB."""
    from difacto_tpu_torch.probes import common

    a, b = cuda_ms(first), cuda_ms(second)
    b2, a2 = cuda_ms(second), cuda_ms(first)
    own = {temp: [t["second"], t["first"]]
           for temp, t in common.kernel_ms_in_turns(
               dev, {"first": first, "second": second}, names).items()}
    return (a + a2) / 2, (b + b2) / 2, own


def no_slower(own):
    """The second of :func:`in_turns` is no slower than the first, warm
    and cold, by kernel time."""
    return all(new <= old for new, old in own.values())


LEAVES = ("w", "z", "n", "cnt", "V", "nV")


def same_bits(got, ref, what: str, against: str) -> None:
    """Fail unless two planar states hold the same bits in every leaf."""
    import torch

    for leaf in LEAVES:
        x, y = getattr(got, leaf), getattr(ref, leaf)
        if not torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32)):
            raise AssertionError(f"{what} differs from {against}: {leaf} "
                                 "(tolerance: bit-equal)")


# the planar apply's calls timed in turns with B2 (planar_turns): the two
# entries by their default (B2's kernel) and by the tiles of
# csrc/planar_apply.cu, and the tiles' rmwonly floor
PLANAR_CALLS = ("apply_pairs2", "apply_packed", "apply_pairs2 tiles",
                "apply_packed tiles", "apply_pairs2 rmwonly",
                "apply_packed rmwonly")
PLANAR_NAMES = ("apply_pairs_kernel", "planar_apply_kernel")
# the kernels line's keys beyond the contract's, each measured in the run
EXTRA_KEYS = ("kernel_ms", "kernel_ms_flushed", "tiles_kernel_ms",
              "tiles_kernel_ms_flushed", "rmwonly_ms", "rmwonly_ms_flushed",
              "b2_kernel_ms", "b2_kernel_ms_flushed", "readonly_ms",
              "readonly_ms_flushed", "b1_kernel_ms", "b1_kernel_ms_flushed")
# the figures at FFM's width (K = 96) of the kernels of its path, each
# measured in the run (k96_launches: the FFM main paths' drives)
WIDTH_KEYS = ("launches", "max_abs_err", "ms", "kernel_ms",
              "kernel_ms_flushed", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
K96_KEYS = tuple(f"k96_{key}" for key in WIDTH_KEYS)
# ... likewise at libffm Criteo's width (K = 156: k156_launches from its
# main paths) and at K = 640 (k640_launches: its learner steps)
K156_KEYS = tuple(f"k156_{key}" for key in WIDTH_KEYS)
K640_KEYS = tuple(f"k640_{key}" for key in WIDTH_KEYS)


def planar_floor(pb, base, q) -> dict:
    """The byte bound (ms, what bounds it) and the sector floor (ms, and
    the table's distinct 32-byte sectors) of a planar apply of the batch's
    real ids, all touched, on ``base``: the floor counts every sector the
    update reads and then writes (one leaf row holds 8 ids a sector) and
    the uid and payload bytes the bound counts, over 3.35 TB/s."""
    import torch

    k, U = q.V_dim, pb.uids.shape[0]
    real = pb.uids[pb.valid].long()
    gated = real[base.cnt[real] >= q.V_threshold] if k else real[:0]
    n_valid, act = real.numel(), gated.numel()
    stream = 4 * (U + 3 * n_valid + k * act)
    b_ms, b_by = bound(stream + updater_bytes(q.w_updater, q.V_updater, k,
                                              n_valid, act),
                       20 * n_valid + 8 * k * act)
    wl = {"ftrl": 3, "adagrad": 2, "sgd": 1}[q.w_updater] + 1
    vl = {"adagrad": 2, "sgd": 1}[q.V_updater] * k
    sectors = (wl * torch.unique(real // 8).numel()
               + vl * torch.unique(gated // 8).numel())
    return dict(touched=n_valid, past_gate=act, bound_ms=b_ms,
                bound_by=b_by, sectors=sectors,
                floor_ms=(2 * 32 * sectors + stream) / HBM_BYTES_PER_S * 1e3)


def planar_turns(dev, pb, base, q, payload, calls) -> dict:
    """Kernel time by torch.profiler, warm and L2-flushed, of B2's planar
    kernel and of ``calls`` (names of PLANAR_CALLS) in turns, each on its
    own copy of ``base``. The payload's add_cnt row is zeroed, so that
    the counts, and with them the rows past the V gate, stay those the
    byte bound and the sector floor count (a series with counts adding up
    takes every touched row past the gate after two calls). Returns, per
    entry timed, its figures for the kernels line."""
    from difacto_tpu_torch.ops import pair_sweep
    from difacto_tpu_torch.probes import common
    from difacto_tpu_torch.probes import hw_packed_pairs as packed

    k = q.V_dim
    fixed = payload.clone()
    fixed[1 + k] = 0.0
    uids = pb.uids
    fl = planar_floor(pb, base, q)
    b2, mine = clone_state(base), clone_state(base)
    A, B = (packed.pack_state(base) if any(
        name.startswith("apply_packed") for name in calls) else (None, None))
    fns = {"apply_pairs": lambda: pair_sweep.apply_pairs(b2, uids, fixed, q)}
    for name in calls:  # "entry [stage word]"; the entry's default without
        entry, *word = name.split()
        if entry == "apply_packed":
            fns[name] = lambda word=word: packed.apply_packed(
                A, B, uids, fixed, q, *word)
        else:
            fns[name] = lambda word=word: pair_sweep.apply_pairs2(
                mine, uids, fixed, q, *word)
    own = common.kernel_ms_in_turns(dev, fns, PLANAR_NAMES)
    log(f"planar apply {q.w_updater}/{q.V_updater} K={k} in turns with B2, "
        f"kernel ms with the gate fixed: {json.dumps(own)}; {json.dumps(fl)}")
    recs = {}
    for name in ("apply_pairs2", "apply_packed"):
        if name not in fns:
            continue
        rec = {}
        for key, label in (("kernel", name), ("tiles_kernel", f"{name} tiles"),
                           ("b2_kernel", "apply_pairs"),
                           ("rmwonly", f"{name} rmwonly")):
            if label in fns:
                rec[f"{key}_ms"] = own["warm"][label]
                rec[f"{key}_ms_flushed"] = own["cold"][label]
        recs[name] = rec
    del b2, mine, A, B
    return recs


def check_segsum(dev, pb, g, pp: int) -> dict:
    """Phase 2, B3 in its three designs on a ``pp``-row payload over the
    batch's sorted slots: segsum_sorted (the one FFM's and K = 0's paths
    run),
    segsum_sorted_chunks (the first design) and segsum_sorted_rows
    (row-major payload, up to its 256 payload columns). Each against the
    float64 sums, exact on integers, untouched lanes 0, and the same bits
    on a second run; then timed in turns, warm and flushed, and
    segsum_sorted must be the fastest. Returns their records."""
    import torch

    from difacto_tpu_torch.ops import segsum
    from difacto_tpu_torch.probes import common

    U = pb.uids.shape[0]
    lanes = pb.sorted_slots.inv_sorted
    blp, bl = lanes.shape[0], pb.vals.numel()
    payT = torch.randn((pp, blp), generator=g, device=dev)
    payT[:, bl:] = 0.0
    # integers in [1, 8]: every partial sum stays below 2^24 and is exact
    # in float32, so a slot or tile piece lost or added twice shows,
    # however long the hot key's segment (the float64 bound is loose there)
    ipay = torch.randint(1, 9, (pp, blp), generator=g, device=dev).float()
    ipay[:, bl:] = 0.0
    pay_rm, ipay_rm = payT.T.contiguous(), ipay.T.contiguous()
    seg_designs = {
        "segsum_sorted": (lambda x, xr: segsum.segsum_sorted(x, lanes, U),
                          "difacto_tpu_torch/csrc/segsum_tiles.cu"),
        "segsum_chunks": (lambda x, xr: segsum.segsum_sorted_chunks(
            x, lanes, U), "difacto_tpu_torch/csrc/segsum.cu"),
        "segsum_rows": (lambda x, xr: segsum.segsum_sorted_rows(xr, lanes, U),
                        "difacto_tpu_torch/csrc/segsum_tiles.cu"),
    }
    if pp > segsum.ROWS_MAX_COLS:  # the probe design's limit; no path's
        del seg_designs["segsum_rows"]
    ref = segsum.segsum_sorted_plain(payT.double(), lanes, U)
    seg_n = torch.bincount(lanes.long(), minlength=U).double()
    tol = f64_sum_tolerance(seg_n, segsum.segsum_sorted_plain(
        payT.abs().double(), lanes, U))
    untouched = seg_n == 0
    iref = segsum.segsum_sorted_plain(ipay, lanes, U)
    seg_err = {}
    for name, (fn, _) in seg_designs.items():
        got = fn(payT, pay_rm)
        diff = (got.double() - ref).abs()
        seg_err[name] = float(diff.max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"{name} on {pp} rows differs from its plain "
                                 f"version beyond the float32 summation "
                                 f"bound (max abs err {seg_err[name]:g})")
        if not bool((got[:, untouched] == 0).all()):
            raise AssertionError(f"{name} on {pp} rows: untouched lanes are "
                                 "not 0")
        if not torch.equal(fn(payT, pay_rm), got):
            raise AssertionError(f"{name} on {pp} rows: a second run gave "
                                 "other bits")
        if not torch.equal(fn(ipay, ipay_rm), iref):
            raise AssertionError(f"{name} on {pp} rows differs from its plain "
                                 "version on an integer payload (tolerance: "
                                 "exact)")
    log(f"segsum on {pp} payload rows: hottest segment {int(seg_n.max())} "
        f"slots; max abs err against the float64 sums {json.dumps(seg_err)}; "
        "integer payload exact, untouched lanes 0 and a second run "
        "bit-equal, all designs")
    del ipay, ipay_rm, ref, iref, tol
    lanes_l = lanes.long()
    acc = torch.zeros((pp, U), device=dev)
    b_ms, b_by = bound(4 * (pp * blp + blp + pp * U), pp * blp)
    seg_names = ("segsum", "Memset")  # each design's kernels and its memset
    calls = {name: (lambda f=f: f[0](payT, pay_rm))
             for name, f in seg_designs.items()}
    order = list(calls) + list(calls)[::-1]
    seg_ms = dict.fromkeys(calls, 0.0)
    for name in order:
        seg_ms[name] += cuda_ms(calls[name]) / 2
    own = common.kernel_ms_in_turns(dev, calls, seg_names)
    log(f"segsum designs on {pp} payload rows in turns, kernel time with the "
        f"memset: {json.dumps(own)}; by events {json.dumps(seg_ms)}")
    if not all(t["segsum_sorted"] <= min(t.values()) for t in own.values()):
        raise AssertionError(f"the paths' segsum_sorted is not the fastest of "
                             f"the three designs on {pp} rows: {own}")
    plain_ms = cuda_ms(lambda: segsum.segsum_sorted_plain(payT, lanes, U))
    library_ms = cuda_ms(lambda: acc.index_add_(1, lanes_l, payT))
    return {name: dict(
        route="cuda", source=seg_designs[name][1],
        replaces="difacto_tpu/ops/segsum.py:156", max_abs_err=seg_err[name],
        ms=seg_ms[name], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, kernel_ms=own["warm"][name],
        kernel_ms_flushed=own["cold"][name]) for name in seg_designs}


def all_kernels_ms(fn) -> float:
    """The card's time per call of ``fn`` over every kernel it launches:
    for a composition of PyTorch ops."""
    from difacto_tpu_torch.probes import common

    return sum(common.kernel_times(fn, REPS).values())


def check_segsum_fm(dev, g, shapes: dict) -> dict:
    """Phase 2, FM's fused per-key sums (segsum_fm: fm_keysum_kernel and
    fm_keysum_join) at K factors on each of ``shapes`` ({label: placed
    PreppedBatch with its sorted slots}): bit for bit (int32 views) the
    composition the step ran before (segsum_fm_plain: the gathered
    payload, B3, the combine in PyTorch ops), one launch a call; then
    timed in turns with it, warm and L2-flushed, every kernel of each
    counted. Bound: the useful bytes, a lane, an example
    and a value a slot, the d|S rows once, the touched lanes' pulled
    factors, the 1 + K sums out. Returns {"segsum_fm": record}, the
    record's figures the first shape's, each shape's under its label."""
    import torch

    from difacto_tpu_torch.ops import cuda, segsum
    from difacto_tpu_torch.probes import common

    rec = {}
    for label, pb in shapes.items():
        ss = pb.sorted_slots
        lanes, x_s, bidx = ss.inv_sorted, ss.x_sorted, ss.bidx
        B, U = pb.vals.shape[0], pb.uids.shape[0]
        d = torch.randn(B, generator=g, device=dev)
        S = torch.randn((B, K), generator=g, device=dev)
        # the pulled rows as the store hands them: a [U, 1 + K] view of
        # the pull's planar [1 + K, U]
        rows_u = torch.randn((1 + K, U), generator=g, device=dev).T
        args = (d, S, x_s, bidx, lanes, rows_u)
        n0 = cuda.LAUNCHES["segsum_fm"]
        got = segsum.segsum_fm(*args)
        if cuda.LAUNCHES["segsum_fm"] != n0 + 1:
            raise AssertionError(f"segsum_fm ({label}) did not launch once")
        want = segsum.segsum_fm_plain(*args)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"segsum_fm ({label}) differs from the "
                                 f"composition in {bad} of {got.numel()} "
                                 "floats (tolerance: exact)")
        if not torch.equal(segsum.segsum_fm(*args), got):
            raise AssertionError(f"segsum_fm ({label}): a second run gave "
                                 "other bits")
        calls = {"fused": lambda: segsum.segsum_fm(*args),
                 "composition": lambda: segsum.segsum_fm_plain(*args)}
        order = list(calls) + list(calls)[::-1]
        own = {"warm": dict.fromkeys(calls, 0.0),
               "cold": dict.fromkeys(calls, 0.0)}
        events = dict.fromkeys(calls, 0.0)
        # flushed: the flush and the call, less the flush alone
        flush_ms = all_kernels_ms(lambda: common.flush_l2(dev))
        for name in order:
            own["warm"][name] += all_kernels_ms(calls[name]) / 2
            own["cold"][name] += (all_kernels_ms(
                lambda: (common.flush_l2(dev), calls[name]()))
                - flush_ms) / 2
            events[name] += cuda_ms(calls[name]) / 2
        blp, n_touched = lanes.shape[0], int(pb.valid.sum())
        b_ms, b_by = bound(4 * (3 * blp + B * (1 + K) + K * n_touched
                                + (1 + K) * U), 0)
        fig = dict(slots=blp, lanes=U, touched=n_touched,
                   hottest=int(torch.bincount(lanes.long()).max()),
                   ms=events["fused"], kernel_ms=own["warm"]["fused"],
                   kernel_ms_flushed=own["cold"]["fused"],
                   composition_ms=own["warm"]["composition"],
                   composition_ms_flushed=own["cold"]["composition"],
                   composition_events_ms=events["composition"],
                   bound_ms=b_ms, bound_by=b_by)
        log(f"segsum_fm at K = {K} on the {label} batch ({B} rows): the "
            f"composition's bits; in turns (all kernels, ms): "
            f"{json.dumps(fig)}")
        if not rec:
            rec = dict(route="cuda",
                       source="difacto_tpu_torch/csrc/segsum_tiles.cu",
                       replaces="difacto_tpu/ops/segsum.py:156", max_abs_err=0.0,
                       ms=fig["ms"], plain_ms=events["composition"],
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       kernel_ms=fig["kernel_ms"],
                       kernel_ms_flushed=fig["kernel_ms_flushed"])
        rec[label] = fig
        del got, want, d, S, rows_u
    return {"segsum_fm": rec}


def check_kernels(dev):
    """Phase 2: every kernel against its plain version at the flagship
    shapes. Returns the kernels' records (without launches)."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.ops import cuda, pair_sweep, segsum
    from difacto_tpu_torch.probes import common
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.place import place_batch

    num_rows = 1 << NUM_BITS
    pb = prep_batch(flagship_batch(0), num_rows)
    pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals)
    pb = place_batch(pb, dev)
    U = pb.uids.shape[0]
    n_valid = int(pb.valid.sum())
    blp = pb.sorted_slots.inv_sorted.shape[0]
    log(f"flagship batch: {BATCH} x {NNZ} slots, {n_valid} unique ids in a "
        f"{U}-lane bucket, BLp {blp}, table 2^{NUM_BITS} rows, K {K}")
    p = FMParam()
    p.V_dim = K
    upd = FMUpdater(p)
    st = random_state(upd, num_rows, dev, seed=1)
    out = {}

    # -- pull: exact (a pure gather with a mask) --------------------------
    got = pair_sweep.pull_pairs(st, pb.uids, p)
    ref = pair_sweep.pull_pairs_plain(st, pb.uids, p)
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"pull_pairs differs from its plain version "
                             f"(max abs err {err:g}; tolerance: exact)")
    n_act = past_gate(pb, st, p)
    nbytes = 4 * (U + 2 * n_valid + K * n_act + (1 + K) * U)
    b_ms, b_by = bound(nbytes, 0)
    out["pull_pairs"] = dict(
        route="cuda", source="difacto_tpu_torch/csrc/pull_pairs.cu",
        replaces="difacto_tpu/ops/pair_sweep.py:346", max_abs_err=err,
        ms=cuda_ms(lambda: pair_sweep.pull_pairs(st, pb.uids, p)),
        plain_ms=cuda_ms(lambda: pair_sweep.pull_pairs_plain(st, pb.uids, p)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    # -- segsum: B3's three designs on the FM payload's 2 + K rows; then
    # segsum_sorted on more rows than one block has threads --------------
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    out.update(check_segsum(dev, pb, g, 2 + K))
    # FM's fused per-key sums, at the flagship's batch and at the FM
    # cells'
    cells = {}
    # one batch of each FM cell's traffic (fmbench/traffic/replay_large.json,
    # replay_flat.json): Zipf(1.2) hashed as the flagship's, or uniform
    for kind, draw in (("large", common.flagship_batch),
                       ("flat", common.uniform_batch)):
        cb = prep_batch(draw(3, FM_CELL_BATCH, NNZ, NUM_BITS), num_rows)
        cb.sorted_slots = build_sorted_slots(cb.inv, cb.vals)
        cells[f"replay_{kind}"] = place_batch(cb, dev)
    gf = torch.Generator(device=dev)                  # the checks after
    gf.manual_seed(16)                                # draw from g as before
    out.update(check_segsum_fm(dev, gf, {"flagship": pb, **cells}))
    del cells, cb, gf
    # more payload rows than the second pass's block has threads (V_dim
    # > 254), with a run that crosses more tiles than one thread sums
    lw = torch.cat([torch.arange(3000) // 3, torch.full((5000,), 1000),
                    1001 + torch.arange(24768) // 7]).to(dev, torch.int32)
    wpay = torch.randint(1, 9, (300, lw.shape[0]), generator=g,
                         device=dev).float()
    cuda.reset_launches()
    if not torch.equal(segsum.segsum_sorted(wpay, lw, 4600),
                       segsum.segsum_sorted_plain(wpay, lw, 4600)):
        raise AssertionError("segsum_sorted differs from its plain version on "
                             "300 payload rows (tolerance: exact)")
    if cuda.LAUNCHES["segsum_sorted"] != 1:
        raise AssertionError(f"300 payload rows took another kernel: "
                             f"{cuda.LAUNCHES}")
    log("segsum_sorted on 300 payload rows of integers: exact")
    # and FM's fused sums at K = 298 on that stream (2 + K scratch rows:
    # the join's wide mode), bit for bit the composition; from a generator
    # of its own, so the checks after it draw what they drew without it
    nb, gw = 4096, torch.Generator(device=dev)
    gw.manual_seed(298)
    wd = torch.randn(nb, generator=gw, device=dev)
    wS = torch.randn((nb, 298), generator=gw, device=dev)
    wx = torch.randn(lw.shape[0], generator=gw, device=dev)
    wb = torch.randint(0, nb, lw.shape, generator=gw, device=dev,
                       dtype=torch.int32)
    wV = torch.randn((4600, 299), generator=gw, device=dev)
    cuda.reset_launches()
    wgot = segsum.segsum_fm(wd, wS, wx, wb, lw, wV)
    if cuda.LAUNCHES["segsum_fm"] != 1:
        raise AssertionError(f"FM's sums at K = 298 took another kernel: "
                             f"{cuda.LAUNCHES}")
    if not torch.equal(wgot.view(torch.int32), segsum.segsum_fm_plain(
            wd, wS, wx, wb, lw, wV).view(torch.int32)):
        raise AssertionError("segsum_fm differs from the composition at "
                             "K = 298 (tolerance: bit for bit)")
    log("segsum_fm at K = 298 (the join's wide mode): bit for bit")
    del lw, wpay, wd, wS, wx, wb, wV, wgot, gw

    # -- apply on planar leaves (B2 one row per thread; B6 by the entry of
    # csrc/planar_apply.cu): every w/V updater pair, and K = 0; B6 by
    # either design bit for bit against B2's kernel, and the tiles' rmwonly
    # floor must leave every bit of the state as it was ------------------
    vf = pb.valid.to(torch.float32)
    designs = {"apply_pairs": (pair_sweep.apply_pairs,
                               pair_sweep.apply_pairs_plain,
                               "difacto_tpu/ops/pair_sweep.py:449",
                               "apply_pairs.cu"),
               "apply_pairs2": (pair_sweep.apply_pairs2,
                                pair_sweep.apply_pairs2_plain,
                                "difacto_tpu/ops/pair_sweep.py:565",
                                "apply_pairs.cu")}
    worst = dict.fromkeys(designs, 0.0)
    for k, wupd, vupd in UPDATER_CASES:
        q = FMParam()
        q.V_dim, q.w_updater, q.V_updater = k, wupd, vupd
        qu = FMUpdater(q)
        base = st if k == K else random_state(qu, num_rows, dev, seed=3)
        grads = torch.randn((1 + k, U), generator=g, device=dev) * vf
        payload = torch.cat([grads, (pb.ucounts * vf)[None], vf[None]])
        # bytes the update needs: every uid; the gw, add_cnt and touch
        # payload of real lanes; and per touched row the leaves its
        # updaters read and write. The gV payload and V/nV only on rows
        # past the V gate (all real lanes are touched here)
        act = past_gate(pb, base, q)
        nbytes = (4 * (U + 3 * n_valid + k * act)
                  + updater_bytes(wupd, vupd, k, n_valid, act))
        results = {}
        for name, (kernel, plain, replaces, src) in designs.items():
            a = kernel(clone_state(base), pb.uids, payload, q)
            b = plain(clone_state(base), pb.uids, payload, q)
            for leaf in ("w", "z", "n", "cnt", "V", "nV"):
                x, y = getattr(a, leaf), getattr(b, leaf)
                if not x.numel():
                    continue
                # the plain version's division by a scalar runs as a
                # multiply by its float reciprocal on the card: 1 ulp
                worst[name] = max(worst[name], float((x - y).abs().max()))
                torch.testing.assert_close(
                    x, y, rtol=1e-5, atol=1e-6,
                    msg=f"{name} {wupd}/{vupd} K={k} against its plain "
                        f"version: {leaf}")
            if name == "apply_pairs2":
                # the same sums in the same order and the same arithmetic
                # as B2's kernel: the same bits, by either design; rmwonly
                # stores back what it loads
                same_bits(a, results["apply_pairs"],
                          f"apply_pairs2 {wupd}/{vupd} K={k}", "apply_pairs")
                same_bits(kernel(clone_state(base), pb.uids, payload, q,
                                 stage="tiles"), results["apply_pairs"],
                          f"apply_pairs2 tiles {wupd}/{vupd} K={k}",
                          "apply_pairs")
                same_bits(kernel(clone_state(base), pb.uids, payload, q,
                                 stage="rmwonly"), base,
                          f"apply_pairs2 rmwonly {wupd}/{vupd} K={k}",
                          "the state it was given")
            results[name] = a
            work = clone_state(base)
            rec = dict(
                ms=cuda_ms(lambda: kernel(work, pb.uids, payload, q)),
                plain_ms=cuda_ms(lambda: plain(work, pb.uids, payload, q)),
            )
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 20 * n_valid
                                                     + 8 * k * act)
            log(f"{name} {wupd}/{vupd} K={k} ({n_valid} touched rows, "
                f"{act} past the V gate): {json.dumps(rec)}")
            if (k, wupd, vupd) == (K, "ftrl", "adagrad"):  # the main path's
                out[name] = dict(
                    route="cuda", source=f"difacto_tpu_torch/csrc/{src}",
                    replaces=replaces, **rec, library_ms=None,
                )
            del work, a, b
        del results
        if k != K or wupd != "ftrl":  # the main path's case: planar_turns
            planar_turns(dev, pb, base, q, payload, PLANAR_CALLS[:4])
    for name in designs:
        out[name]["max_abs_err"] = worst[name]
    # B6 and S1b in turns with B2 on the main path's case, by both designs,
    # with the tiles' rmwonly floor, the byte bound and the sector floor
    planar = planar_turns(dev, pb, st, p, torch.cat(
        [torch.randn((1 + K, U), generator=g, device=dev) * vf,
         (pb.ucounts * vf)[None], vf[None]]), PLANAR_CALLS)
    out["apply_pairs2"].update(planar["apply_pairs2"])
    out.update(check_sweep_kernels(dev, pb, st, g, K))
    out.update(check_probe_kernels(dev, pb, st, g, planar["apply_packed"]))
    rm = check_rowmajor_kernels(dev, pb, st, K)
    for name in ("pull_pairs", "apply_pairs"):  # their time in those turns
        planar_rec = rm.pop(name)
        for key in ("kernel_ms", "kernel_ms_flushed"):
            out[name][key] = planar_rec[key]
    out.update(rm)
    for name, rec in out.items():
        log(f"kernel {name}: max_abs_err {rec['max_abs_err']:g}  "
            f"{rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})  "
            f"library {rec['library_ms']}")
    return out


# K1 (phase 2): B2 over the sharded store owner's receive stream, S sorted
# segments of C lanes, at the flagship's width, with S = 2 and 4
K1_KERNELS = ("apply_pairs_segs", "apply_rowmajor_segs")
K1_SEGMENTS = (2, 4)
# K1's first pass, the stable merge of the segments (csrc/seg_merge.cu)
MERGE = "merge_segments"
# the CUDA functions of each K1 call in a torch.profiler trace: the merge
# and the one-stream apply; and those of the search design, the yardstick
K1_TRACE = {"apply_pairs_segs": ("merge_segments_kernel",
                                 "apply_pairs_kernel"),
            "apply_rowmajor_segs": ("merge_segments_kernel",
                                    "rowmajor_apply_kernel")}
K1_SEARCH_TRACE = {"apply_pairs_segs": ("apply_pairs_segs_kernel",),
                   "apply_rowmajor_segs": ("rowmajor_apply_kernel",)}
# the search design's counters, 0 on every path
K1_SEARCH = ("apply_pairs_segs_search", "apply_rowmajor_segs_search")
# K1's and the merge's keys in the kernels line beyond the contract's:
# the segments of their figures (S = 2), their figures at S = 4, the
# search design's times in the same turns, the merge's time, and the
# kernel the merge is a pass of
K1_KEYS = ("segments", "seg_len", "s4", "search_ms", "search_kernel_ms",
           "search_kernel_ms_flushed", "merge_kernel_ms",
           "merge_kernel_ms_flushed", "part_of")


def k1_stream(S: int, seed: int, disjoint: bool = False):
    """Owner 0's receive stream of a flagship batch prepped over S row
    groups: S segments of C lanes, C the pairs path's capacity for the
    batch (its largest bucket fill, W-aligned, up the ladder), segment s
    the sorted ids source s sends to owner 0 with the local sentinel
    ``rows_per_shard`` after them. Zipf(1.2) ids repeat across segments;
    ``disjoint`` keeps in segment s only the ids with id % S == s. Returns
    (uids i32 [S*C], valid bool, C, rows_per_shard)."""
    from difacto_tpu_torch.data.prep import prep_batch_sharded
    from difacto_tpu_torch.parallel.store import (PAIR_WINDOW, _cap_ladder,
                                                  _round_up)

    num_rows = 1 << NUM_BITS
    rps = num_rows // S
    pb = prep_batch_sharded(flagship_batch(seed), num_rows, S)
    C = _cap_ladder(_round_up(pb.max_fill, PAIR_WINDOW))
    segs = []
    for s, u in enumerate(pb.uids.reshape(S, pb.ub)):
        ids = u[u < rps]
        if disjoint:
            ids = ids[ids % S == s]
        seg = np.full(C, rps, np.int32)
        seg[:len(ids)] = ids
        segs.append(seg)
    uids = np.concatenate(segs)
    return uids, uids < rps, C, rps


def check_k1_kernels(dev) -> dict:
    """Phase 2, K1 on both layouts at the flagship's width (K = 16,
    FTRL/AdaGrad) on owner 0's stream of S = 2 and 4 segments, by the
    paths' route (the merge, csrc/seg_merge.cu, then the one-stream apply
    on the merged stream): the merge exact against its plain version (a
    stable sort and a gather); K1 against its plain version (the plain
    merge, then the one-stream plain apply) at B2's tolerance (rtol 1e-5,
    atol 1e-6: the plain division runs as a multiply by the reciprocal on
    the card), the two layouts bit for bit, and bit for bit against the
    search design (``apply_pairs_segs_search``, the yardstick); an integer
    payload through SGD with unit rates on a zero table exact against the
    float64 sums; segments of disjoint ids bit for bit against the
    one-stream kernels on the same lanes merged into one sorted stream.
    Each layout's route timed in turns with the search design (search,
    merge, merge, search: CUDA events, torch.profiler warm and
    L2-flushed, K1's kernel time the merge's plus the apply's); fails if
    the route is slower. The merge timed alone. Returns the records of K1
    and of the merge (at S = 2, the P8 run's) without launches."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.ops import pair_sweep
    from difacto_tpu_torch.probes import common
    from difacto_tpu_torch.updaters.updater import (FMUpdater, pack_state,
                                                    unpack_state)

    p = FMParam()
    p.V_dim = K
    upd = FMUpdater(p)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    out, worst = {}, dict.fromkeys(K1_KERNELS + (MERGE,), 0.0)
    for S in K1_SEGMENTS:
        uids_np, valid_np, C, rps = k1_stream(S, 50 + S)
        uids = torch.from_numpy(uids_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        U, n_lanes = uids.shape[0], int(valid.sum())
        st = random_state(upd, rps, dev, seed=20 + S)
        vf = valid.float()
        pay = torch.cat([torch.randn((1 + K, U), generator=g, device=dev) * vf,
                         torch.randint(1, 4, (1, U), generator=g,
                                       device=dev) * vf, vf[None]])

        def run(layout, state=None, payload=pay, q=p, ids=uids, seg=C,
                search=False):
            base = clone_state(st if state is None else state)
            if layout == "packed":
                base = pack_state(base)
            got = (pair_sweep.apply_pairs_segs_search(base, ids, payload, q,
                                                      seg) if search
                   else pair_sweep.apply_pairs(base, ids, payload, q,
                                               seg_len=seg))
            return unpack_state(got) if layout == "packed" else got

        # the merge against its plain version, the sentinel lanes' columns
        # told apart
        tagged = torch.where(valid, pay, torch.arange(
            U, dtype=torch.float32, device=dev))
        mu, mp = pair_sweep.merge_segments(uids, tagged, C)
        ru, rp = pair_sweep.merge_segments_plain(uids, tagged, C)
        if not (torch.equal(mu, ru) and torch.equal(mp, rp)):
            raise AssertionError(f"merge_segments S={S} differs from its "
                                 "plain version (tolerance: exact)")
        worst[MERGE] = max(worst[MERGE], float((mp - rp).abs().max()))
        del tagged, mu, mp, ru, rp
        ref = pair_sweep.apply_pairs_segs_plain(clone_state(st), uids, pay, p,
                                                C)
        got = {lay: run(lay) for lay in ("planar", "packed")}
        for lay, name in zip(("planar", "packed"), K1_KERNELS):
            for leaf in LEAVES:
                x, y = getattr(got[lay], leaf), getattr(ref, leaf)
                worst[name] = max(worst[name], float((x - y).abs().max()))
                torch.testing.assert_close(
                    x, y, rtol=1e-5, atol=1e-6,
                    msg=f"{name} S={S} against its plain version: {leaf}")
            same_bits(got[lay], run(lay, search=True), f"{name} S={S}",
                      "the search design")
        same_bits(got["packed"], got["planar"], f"apply_rowmajor_segs S={S}",
                  "apply_pairs_segs")
        # integers in [1, 8], SGD with unit rates on a zero table: w, V and
        # cnt are minus (or plus) the sums, exact in float32
        q = FMParam()
        q.V_dim, q.w_updater, q.V_updater, q.V_threshold = K, "sgd", "sgd", 0
        q.lr_eta, q.l2, q.V_lr_eta, q.V_l2 = 1.0, 0.0, 1.0, 0.0
        zero = FMUpdater(q).init_state(rps, 0, dev)
        zero.V.zero_()
        ipay = torch.randint(1, 9, (3 + K, U), generator=g,
                             device=dev).float() * vf
        exp = torch.zeros((3 + K, rps), dtype=torch.float64, device=dev)
        exp.index_add_(1, uids[valid].long(), ipay[:, valid].double())
        for lay, name in zip(("planar", "packed"), K1_KERNELS):
            a = run(lay, zero, ipay, q)
            if not (torch.equal(a.w, (-exp[0]).float())
                    and torch.equal(a.V, (-exp[1:1 + K]).float())
                    and torch.equal(a.cnt, exp[1 + K].float())):
                raise AssertionError(f"{name} S={S} differs from the float64 "
                                     "sums of an integer payload (tolerance: "
                                     "exact)")
        del zero, ipay, exp
        # disjoint segments: the one-stream kernels' bits
        d_np, dv_np, _, _ = k1_stream(S, 50 + S, disjoint=True)
        order = np.argsort(d_np, kind="stable")
        d_ids = torch.from_numpy(d_np).to(dev)
        m_ids = torch.from_numpy(d_np[order]).to(dev)
        dpay = pay[:, :U].clone()
        mpay = dpay[:, torch.from_numpy(order).to(dev)].contiguous()
        for lay, name in zip(("planar", "packed"), K1_KERNELS):
            one = run(lay, payload=mpay, ids=m_ids, seg=None)
            same_bits(run(lay, payload=dpay, ids=d_ids), one,
                      f"{name} S={S} on disjoint segments",
                      "the one-stream kernel on the merged stream")
        # timing, and the bytes the update needs: every uid; gw, add_cnt
        # and touch of the real lanes, gV of those past the V gate; per
        # touched row the leaves its updaters read and write (the merge's
        # own traffic is not added)
        idx = uids.clamp(max=rps - 1).long()
        gate = valid & (st.cnt[idx] >= p.V_threshold)
        rows = int(torch.unique(uids[valid]).numel())
        act = int(torch.unique(uids[gate]).numel())
        nbytes = (4 * (U + 3 * n_lanes + K * int(gate.sum()))
                  + updater_bytes("ftrl", "adagrad", K, rows, act))
        b_ms, b_by = bound(nbytes, 20 * rows + 8 * K * act)
        # the merge alone: it reads every id and payload value once and
        # writes each once; its S - 1 searches a lane are comparisons
        def merge():
            return pair_sweep.merge_segments(uids, pay, C)

        mown = common.kernel_ms_in_turns(dev, {MERGE: merge},
                                         "merge_segments_kernel")
        mb_ms, mb_by = bound(2 * 4 * U * (1 + 3 + K),
                             U * (S - 1) * int(np.ceil(np.log2(C + 1))))
        mrec = dict(ms=cuda_ms(merge), plain_ms=cuda_ms(
            lambda: pair_sweep.merge_segments_plain(uids, pay, C)),
            kernel_ms=mown["warm"][MERGE],
            kernel_ms_flushed=mown["cold"][MERGE], bound_ms=mb_ms,
            bound_by=mb_by, segments=S, seg_len=C, lanes=U,
            payload_rows=3 + K)
        log(f"{MERGE} S={S} C={C}: {json.dumps(mrec)}")
        plain_ms = cuda_ms(lambda: pair_sweep.apply_pairs_segs_plain(
            clone_state(st), uids, pay, p, C), reps=5)
        for lay, name in zip(("planar", "packed"), K1_KERNELS):
            ws, wm = ((clone_state(st), clone_state(st)) if lay == "planar"
                      else (pack_state(st), pack_state(st)))
            search_ms, merge_ms, own = in_turns(
                dev,
                lambda: pair_sweep.apply_pairs_segs_search(ws, uids, pay, p,
                                                           C),
                lambda: pair_sweep.apply_pairs(wm, uids, pay, p, seg_len=C),
                K1_TRACE[name] + K1_SEARCH_TRACE[name])
            rec = dict(ms=merge_ms, plain_ms=plain_ms,
                       kernel_ms=own["warm"][0],
                       kernel_ms_flushed=own["cold"][0],
                       search_ms=search_ms, search_kernel_ms=own["warm"][1],
                       search_kernel_ms_flushed=own["cold"][1],
                       merge_kernel_ms=mrec["kernel_ms"],
                       merge_kernel_ms_flushed=mrec["kernel_ms_flushed"],
                       bound_ms=b_ms, bound_by=b_by, segments=S, seg_len=C,
                       lanes=n_lanes, rows=rows, rows_past_gate=act)
            log(f"{name} S={S} C={C} ({n_lanes} lanes, {rows} rows, {act} "
                f"past the gate), the merge route in turns with the search "
                f"design (kernel ms [merge route, search] warm and flushed "
                f"{json.dumps(own)}; the merge's share "
                f"{mrec['kernel_ms'] / own['warm'][0]:.3f} warm): "
                f"{json.dumps(rec)}")
            if not no_slower(own):
                raise AssertionError(f"{name} S={S}: the merge route is "
                                     f"slower than the search design: {own}")
            if S == K1_SEGMENTS[0]:
                out[name] = dict(
                    route="cuda",
                    source="difacto_tpu_torch/csrc/" + (
                        "apply_pairs.cu" if name == "apply_pairs_segs"
                        else "rowmajor_pairs.cu"),
                    replaces="difacto_tpu/ops/pair_sweep.py:449",
                    library_ms=None, **rec)
            else:
                out[name][f"s{S}"] = rec
            del ws, wm
        if S == K1_SEGMENTS[0]:
            # no TPU kernel of its own: K1's first pass, where the Pallas
            # kernel walked its seg_len schedule in grid order
            out[MERGE] = dict(
                route="cuda", source="difacto_tpu_torch/csrc/seg_merge.cu",
                replaces="difacto_tpu/ops/pair_sweep.py:449",
                part_of="K1 (apply_pairs_segs, apply_rowmajor_segs)",
                library_ms=None, **mrec)
        else:
            out[MERGE][f"s{S}"] = mrec
    for name in K1_KERNELS + (MERGE,):
        out[name]["max_abs_err"] = worst[name]
    log("K1 on both layouts, S = 2 and 4: the merge exact, plain within "
        "B2's tolerance, the layouts and the search design bit-equal, "
        "integer sums exact, disjoint segments give the one-stream bits, "
        "the merge route no slower than the search design")
    return out


def check_rowmajor_kernels(dev, pb, st, k_main: int) -> dict:
    """Phase 2, the pull and apply over the row-major table
    (layout=packed, csrc/rowmajor_pairs.cu) at ``k_main`` factors, the
    width of ``st``: against their plain versions and, bit for bit,
    against the planar kernels B1 and B2 on the same state; each timed in
    turns with its planar counterpart, warm and flushed, for every updater
    pair and K = 0. Fails if a row-major kernel is slower at ``k_main``
    (``layout=auto`` puts the pairs path with factors on the row-major
    table). Returns the records of the four kernels, the planar ones timed
    in the same turns (``ms``, ``kernel_ms``, ``kernel_ms_flushed``) with
    their plain versions on the planar state."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.ops import pair_sweep
    from difacto_tpu_torch.updaters.updater import (FMUpdater, pack_state,
                                                    unpack_state)

    num_rows = st.num_rows
    U = pb.uids.shape[0]
    n_valid = int(pb.valid.sum())
    p = FMParam()
    p.V_dim = k_main
    out, faster = {}, {}
    # its own draws: the checks before it keep theirs wherever this runs
    g = torch.Generator(device=dev)
    g.manual_seed(4)

    pair_names = ("rowmajor_", "_pairs_kernel")

    def turns_recs(rm_name, planar_name, planar_ms, ms, own, common_rec,
                   rm_plain, planar_plain):
        for name, t, i, plain_fn, src in (
                (rm_name, ms, 0, rm_plain, "rowmajor_pairs.cu"),
                (planar_name, planar_ms, 1, planar_plain, f"{planar_name}.cu")):
            out[name] = dict(
                route="cuda", source=f"difacto_tpu_torch/csrc/{src}", ms=t,
                plain_ms=cuda_ms(plain_fn), library_ms=None,
                kernel_ms=own["warm"][i], kernel_ms_flushed=own["cold"][i],
                **common_rec)

    # -- pull: exact (a gather with a mask); the narrower pieces too -------
    tb = pack_state(st)
    got = pair_sweep.pull_pairs(tb, pb.uids, p)
    refs = [("its plain version", pair_sweep.pull_pairs_plain(tb, pb.uids, p)),
            ("pull_pairs", pair_sweep.pull_pairs(st, pb.uids, p))]
    refs += [(f"its {v}-float pieces",
              pair_sweep._pull_rowmajor(tb, pb.uids, p, vec=v)) for v in (1, 2)]
    for what, ref in refs:
        if not torch.equal(got, ref):
            raise AssertionError(f"pull_rowmajor K={k_main} differs from "
                                 f"{what} (max abs err "
                                 f"{float((got - ref).abs().max()):g}; "
                                 "tolerance: exact)")
    del got, refs
    n_act = past_gate(pb, st, p)
    b_ms, b_by = bound(4 * (U + 2 * n_valid + k_main * n_act
                            + (1 + k_main) * U), 0)
    planar_ms, ms, own = in_turns(
        dev, lambda: pair_sweep.pull_pairs(st, pb.uids, p),
        lambda: pair_sweep.pull_pairs(tb, pb.uids, p), pair_names)
    turns_recs("pull_rowmajor", "pull_pairs", planar_ms, ms, own,
               dict(replaces="difacto_tpu/ops/pair_sweep.py:346",
                    max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by),
               lambda: pair_sweep.pull_pairs_plain(tb, pb.uids, p),
               lambda: pair_sweep.pull_pairs_plain(st, pb.uids, p))
    faster[f"pull K={k_main}"] = no_slower(own)
    scalar_ms = cuda_ms(lambda: pair_sweep._pull_rowmajor(tb, pb.uids, p,
                                                          vec=1))
    log(f"pull_rowmajor K={k_main}: {ms:.4f} ms against pull_pairs "
        f"{planar_ms:.4f} ms in turns; kernel time [row-major, planar] "
        f"{json.dumps(own)}; scalar path (1-float pieces) {scalar_ms:.4f} ms")
    q0 = FMParam()
    q0.V_dim = 0
    st0 = random_state(FMUpdater(q0), num_rows, dev, seed=3)
    tb0 = pack_state(st0)
    if not torch.equal(pair_sweep.pull_pairs(tb0, pb.uids, q0),
                       pair_sweep.pull_pairs(st0, pb.uids, q0)):
        raise AssertionError("pull_rowmajor K=0 differs from pull_pairs")
    planar_ms, ms, own = in_turns(
        dev, lambda: pair_sweep.pull_pairs(st0, pb.uids, q0),
        lambda: pair_sweep.pull_pairs(tb0, pb.uids, q0), pair_names)
    faster["pull K=0"] = no_slower(own)
    log(f"pull_rowmajor K=0: {ms:.4f} ms against pull_pairs {planar_ms:.4f} "
        f"ms; kernel time [row-major, planar] {json.dumps(own)}")
    del tb, tb0

    # -- apply: every updater pair and K = 0; the bits of B2's kernel ------
    vf = pb.valid.to(torch.float32)
    worst = 0.0
    for k, wupd, vupd in UPDATER_CASES:
        k = k_main if k else 0
        q = FMParam()
        q.V_dim, q.w_updater, q.V_updater = k, wupd, vupd
        base = st if k else st0
        grads = torch.randn((1 + k, U), generator=g, device=dev) * vf
        payload = torch.cat([grads, (pb.ucounts * vf)[None], vf[None]])
        act = past_gate(pb, base, q)
        a = unpack_state(pair_sweep.apply_pairs(pack_state(base), pb.uids,
                                                payload, q))
        b = unpack_state(pair_sweep.apply_pairs_plain(pack_state(base),
                                                      pb.uids, payload, q))
        c = pair_sweep.apply_pairs(clone_state(base), pb.uids, payload, q)
        narrow = {v: unpack_state(pair_sweep._apply_rowmajor(
            pack_state(base), pb.uids, payload, q, vec=v)) for v in (1, 2)}
        for leaf in ("w", "z", "n", "cnt", "V", "nV"):
            x = getattr(a, leaf)
            if not x.numel():
                continue
            # the same sums in the same order and the same arithmetic as
            # the planar kernel: the same bits, whatever the piece width
            for what, ref in [("apply_pairs", c)] + [
                    (f"its {v}-float pieces", s_) for v, s_ in narrow.items()]:
                if not torch.equal(x, getattr(ref, leaf)):
                    raise AssertionError(
                        f"apply_rowmajor {wupd}/{vupd} K={k} differs from "
                        f"{what}: {leaf} (tolerance: bit-equal)")
            # the plain version's division by a scalar runs as a multiply
            # by its float reciprocal on the card: 1 ulp
            worst = max(worst, float((x - getattr(b, leaf)).abs().max()))
            torch.testing.assert_close(
                x, getattr(b, leaf), rtol=1e-5, atol=1e-6,
                msg=f"apply_rowmajor {wupd}/{vupd} K={k} against its plain "
                    f"version: {leaf}")
        del a, b, c, narrow
        work, work_p = pack_state(base), clone_state(base)
        planar_ms, ms, own = in_turns(
            dev, lambda: pair_sweep.apply_pairs(work_p, pb.uids, payload, q),
            lambda: pair_sweep.apply_pairs(work, pb.uids, payload, q),
            pair_names)
        nbytes = (4 * (U + 3 * n_valid + k * act)
                  + updater_bytes(wupd, vupd, k, n_valid, act))
        rec = dict(ms=ms, plain_ms=cuda_ms(
            lambda: pair_sweep.apply_pairs_plain(work, pb.uids, payload, q)))
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 20 * n_valid
                                                 + 8 * k * act)
        faster[f"apply {wupd}/{vupd} K={k}"] = no_slower(own)
        scalar_ms = cuda_ms(lambda: pair_sweep._apply_rowmajor(
            work, pb.uids, payload, q, vec=1))
        log(f"apply_rowmajor {wupd}/{vupd} K={k} ({n_valid} touched rows, "
            f"{act} past the V gate): {json.dumps(rec)}; apply_pairs in "
            f"turns {planar_ms:.4f} ms; kernel time [row-major, planar] "
            f"{json.dumps(own)}; scalar path {scalar_ms:.4f} ms")
        if (k, wupd, vupd) == (k_main, "ftrl", "adagrad"):  # the main path's
            turns_recs("apply_rowmajor", "apply_pairs", planar_ms, ms, own,
                       dict(replaces="difacto_tpu/ops/pair_sweep.py:449",
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"]),
                       lambda: pair_sweep.apply_pairs_plain(
                           work, pb.uids, payload, q),
                       lambda: pair_sweep.apply_pairs_plain(
                           work_p, pb.uids, payload, q))
        del work, work_p
    # the row-major apply has B2's bits: the same error against the plain
    # version
    for name in ("apply_rowmajor", "apply_pairs"):
        out[name]["max_abs_err"] = worst
    by_k = {f"K={k}": all(v for name, v in faster.items()
                          if name.endswith(f"K={k}")) for k in (k_main, 0)}
    log(f"row-major kernels no slower than the planar ones by kernel time, "
        f"warm and cold: {json.dumps(faster)}; every case of one width: "
        f"{json.dumps(by_k)} (what parallel/store.py::_resolve_layout gives "
        "layout=auto on the pairs path follows this line: packed for the "
        "widths where every case holds)")
    if not by_k[f"K={k_main}"]:
        raise AssertionError("layout=auto puts the pairs path with factors on "
                             "the row-major table, where a kernel is now "
                             f"slower than its planar one at K={k_main}: "
                             f"{faster}")
    return out


def ffm_batch(seed: int):
    """One config-5 batch: 4096 rows of 24 Zipf(1.2) ids hashed into 2^22
    rows as scripts/hw_ffm_sorted.py draws them, unit values."""
    from difacto_tpu_torch.probes import common

    return common.flagship_batch(seed, FFM_BATCH, FFM_NNZ, NUM_BITS)


def check_width(dev, pb, st, g, k: int, prefix: str) -> dict:
    """Phase 2's checks of the flagship's width at another width ``k``
    (the width of ``st``), on a batch of that model: B3's designs on its
    1 + k payload rows, the pull and apply over the row-major table and
    the sweep kernels against their plain versions and, bit for bit,
    against the planar kernels, timed in turns with them (each fails if
    a row-major kernel is slower, since ``layout=auto`` puts these widths
    on the row-major table). Returns {kernel: its ``prefix``_ figures}."""
    recs = {"segsum_sorted": check_segsum(dev, pb, g, 1 + k)["segsum_sorted"],
            **check_rowmajor_kernels(dev, pb, st, k),
            **check_sweep_kernels(dev, pb, st, g, k)}
    return {name: {f"{prefix}_{key}": rec[key] for key in WIDTH_KEYS
                   if key in rec} for name, rec in recs.items()}


def check_ffm_kernels(dev) -> tuple[dict, float]:
    """Phase 2 at FFM's width, on a config-5 batch and a state of K = 96
    factors: :func:`check_width`, and ``ffm_loss_grad`` on the card
    against the CPU. Returns ({kernel of the FFM paths: its K96_KEYS
    figures}, ffm_loss_grad ms)."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.place import place_batch

    num_rows, Kf = 1 << NUM_BITS, FFM_WIDTH
    pb = prep_batch(ffm_batch(30), num_rows)
    pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals, with_slots=True)
    pb = place_batch(pb, dev)
    U = pb.uids.shape[0]
    n_valid = int(pb.valid.sum())
    p = FMParam()
    p.V_dim = Kf
    st = random_state(FMUpdater(p), num_rows, dev, seed=31)
    log(f"config-5 batch: {FFM_BATCH} x {FFM_NNZ} slots, {n_valid} unique "
        f"ids in a {U}-lane bucket ({past_gate(pb, st, p)} past the V gate), "
        f"BLp {pb.sorted_slots.inv_sorted.shape[0]}, table 2^{NUM_BITS} rows, "
        f"K = F*k = {Kf}")
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    out = check_width(dev, pb, st, g, Kf, "k96")
    loss_ms = check_ffm_loss(dev, pb, g, FFM_NNZ, FFM_K, "config 5")
    del st
    return out, loss_ms


def check_ffm_loss(dev, pb, g, F: int, k: int, what: str) -> float:
    """``ffm_loss_grad`` on the card against the CPU on the placed batch
    ``pb`` (its explicit fields when it has them, else the slot position)
    with random rows of F*k factors. Returns its ms by events."""
    import torch

    from difacto_tpu_torch.models import losses

    B, L = pb.vals.shape
    rows = torch.randn((B, L, 1 + F * k), generator=g, device=dev) * 0.1
    args = (pb.vals, rows[..., 0], rows[..., 1:].reshape(B, L, F, k),
            pb.labels, pb.mask)
    fields = pb.fields
    fwd, grads = losses.ffm_loss_grad(*args, fields=fields)
    cfwd, cgrads = losses.ffm_loss_grad(
        *(t.cpu() for t in args),
        fields=None if fields is None else fields.cpu())
    for name, x, y in (("py", fwd.py, cfwd.py), ("dW", grads.dW, cgrads.dW),
                       ("dV", grads.dV, cgrads.dV)):
        # L(L-1) cross terms a row, summed in another order on the card
        torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-5,
                                   msg=f"ffm_loss_grad on the card: {name}")
    loss_ms = cuda_ms(lambda: losses.ffm_loss_grad(*args, fields=fields))
    fwd_ms = cuda_ms(lambda: losses.ffm_predict(*args[:3], fields=fields))
    log(f"ffm_loss_grad at {what} ({B} x {L} x {F} x {k}, fields "
        f"{'explicit' if fields is not None else 'by slot'}) matches the CPU "
        f"(rtol 1e-5, atol 1e-5): {loss_ms:.4f} ms by events, the forward "
        f"alone {fwd_ms:.4f} ms")
    return loss_ms


def libffm_block(rows: int, seed: int):
    """Criteo-shaped libffm rows: 39 fields of Zipf-popular values with an
    FM ground truth (data/synthetic.py), each row's slots shuffled, so
    that the field is not the slot position."""
    from difacto_tpu_torch.data.synthetic import make_ctr_data

    return make_ctr_data(rows, num_fields=LIBFFM_FIELDS, seed=seed,
                         with_fields=True, shuffle_slots=True)


def check_libffm_kernels(dev) -> tuple[dict, float]:
    """Phase 2 at libffm Criteo's width (K = 156, 157 payload rows), on
    one of its batches (4096 x 39 slots, explicit shuffled fields) and a
    2^22-row state: :func:`check_width`, and ``ffm_loss_grad`` with the
    batch's fields on the card against the CPU. Returns ({kernel: its
    K156_KEYS figures}, ffm_loss_grad ms)."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.data.batch_iter import rowblock_to_batches
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.place import place_batch

    num_rows, Kf = 1 << NUM_BITS, LIBFFM_WIDTH
    b = next(rowblock_to_batches(libffm_block(LIBFFM_BATCH, 40),
                                 LIBFFM_BATCH, LIBFFM_FIELDS, NUM_BITS))
    pb = prep_batch(b, num_rows, num_fields=LIBFFM_FIELDS)
    pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals, with_slots=True)
    pb = place_batch(pb, dev)
    p = FMParam()
    p.V_dim = Kf
    st = random_state(FMUpdater(p), num_rows, dev, seed=41)
    log(f"libffm batch: {LIBFFM_BATCH} x {LIBFFM_FIELDS} slots, "
        f"{int(pb.valid.sum())} unique ids in a {pb.uids.shape[0]}-lane "
        f"bucket ({past_gate(pb, st, p)} past the V gate), table "
        f"2^{NUM_BITS} rows, K = F*k = {Kf}")
    g = torch.Generator(device=dev)
    g.manual_seed(42)
    out = check_width(dev, pb, st, g, Kf, "k156")
    loss_ms = check_ffm_loss(dev, pb, g, LIBFFM_FIELDS, LIBFFM_K,
                             "libffm Criteo")
    del st
    return out, loss_ms


def check_wide_kernels(dev) -> dict:
    """Phase 2 past one shared-memory tile of the row-major kernels: a
    512 x 40 batch of FFM with the slot position as field (k = 16, so
    K = 640) and a 2^16-row state, :func:`check_width`; then the train
    and eval steps of ``kernel=auto`` at that width against the CPU,
    whose launches the K640 figures keep. Returns {kernel: its K640_KEYS
    figures}."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.probes import common
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.place import place_batch

    num_rows, Kf = 1 << WIDE_BITS, WIDE_WIDTH
    pb = prep_batch(common.flagship_batch(50, WIDE_BATCH, WIDE_NNZ,
                                          WIDE_BITS), num_rows)
    pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals, with_slots=True)
    pb = place_batch(pb, dev)
    p = FMParam()
    p.V_dim = Kf
    st = random_state(FMUpdater(p), num_rows, dev, seed=51)
    log(f"K = {Kf} batch: {WIDE_BATCH} x {WIDE_NNZ} slots, "
        f"{int(pb.valid.sum())} unique ids ({past_gate(pb, st, p)} past the "
        f"V gate), table 2^{WIDE_BITS} rows, chunks of 128 factors")
    g = torch.Generator(device=dev)
    g.manual_seed(52)
    out = check_width(dev, pb, st, g, Kf, "k640")
    del st
    cuda.reset_launches()
    check_step_against_cpu(dev, WIDE_NNZ, (("V_dim", str(WIDE_KF)),
                                           ("loss", "ffm")), ((),))
    for name in FFM_ROWMAJOR_KERNELS:
        out[name]["k640_launches"] = cuda.LAUNCHES[name]
        if not cuda.LAUNCHES[name]:
            raise AssertionError(f"the K = {Kf} steps never launched {name}")
    return out


def check_sweep_kernels(dev, pb, st, g, k_main: int):
    """Phase 2, the whole-table sweep kernels, both designs, at ``k_main``
    factors (the width of ``st``): B4 pull and B5 apply over planar leaves
    (csrc/sweep_pull.cu, csrc/sweep_apply.cu) and over the row-major table
    (csrc/rowmajor_sweep.cu). One stream of the batch's sorted unique ids,
    as ops/sweep.py passes it, then two streams of repeated ids, then a
    dense block. Each design against the plain version; the row-major one
    also bit for bit against the planar one after ``unpack_state``, at
    every piece width, and timed in turns with it, warm and with the L2
    flushed. Returns their records."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.ops import sweep, sweep_ms
    from difacto_tpu_torch.updaters.updater import (FMUpdater, pack_state,
                                                    unpack_state)

    num_rows, R = st.num_rows, BLOCK_ROWS
    nb = num_rows // R
    sid = pb.uids  # sorted; the sentinel N on every invalid lane
    off = sweep.offsets_1(sid, num_rows, R)
    U = sid.shape[0]
    n_valid = int(pb.valid.sum())
    p = FMParam()
    p.V_dim = k_main
    out, faster = {}, {}
    names = ("sweep_",)  # every sweep kernel, the planar pull's two and
    #                      the planar apply's order check included
    rm_src = "difacto_tpu_torch/csrc/rowmajor_sweep.cu"

    def pull(state, **kw):
        return sweep_ms.sweep_pull_ms(state, sid, off, p, block_rows=R, **kw)

    # -- pull: exact (a gather with a mask) --------------------------------
    tb = pack_state(st)
    ref = sweep_ms.sweep_pull_ms_plain(st, sid, off, p, block_rows=R)
    for what, got in [("sweep_pull", pull(st)), ("sweep_pull_rowmajor",
                                                pull(tb))] + [
            (f"sweep_pull_rowmajor with {v}-float pieces",
             sweep_ms._sweep_pull_rowmajor(tb, sid, off, p, R, vec=v))
            for v in (1, 2)]:
        if not torch.equal(got, ref):
            raise AssertionError(
                f"{what} differs from its plain version (max abs err "
                f"{float((got - ref).abs().max()):g}; tolerance: exact)")
    n_act = past_gate(pb, st, p)
    # useful bytes: the ids and offsets, w and cnt of the named rows, V of
    # the gated ones, the [1+K, U] output; a full sweep reads w, cnt and V
    # whole instead
    io = 4 * (U + (nb + 1) + (1 + k_main) * U)
    b_ms, b_by = bound(io + 4 * (2 * n_valid + k_main * n_act), 0)
    whole_ms = (io + 4 * (2 + k_main) * num_rows) / HBM_BYTES_PER_S * 1e3
    planar_ms, ms, own = in_turns(dev, lambda: pull(st), lambda: pull(tb),
                                  names)
    plain_ms = cuda_ms(lambda: sweep_ms.sweep_pull_ms_plain(
        st, sid, off, p, block_rows=R))
    for name, src, t, k_ms in (
            ("sweep_pull", "difacto_tpu_torch/csrc/sweep_pull.cu", planar_ms,
             own["warm"][1]),
            ("sweep_pull_rowmajor", rm_src, ms, own["warm"][0])):
        out[name] = dict(
            route="cuda", source=src,
            replaces="difacto_tpu/ops/sweep_ms.py:140", max_abs_err=0.0,
            ms=t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, kernel_ms=k_ms)
    faster[f"pull K={k_main}"] = no_slower(own)
    log(f"sweep_pull: useful-byte bound {b_ms:.5f} ms; a whole-table "
        f"sweep would move {io + 4 * (2 + k_main) * num_rows} B, "
        f"{whole_ms:.5f} ms; row-major {ms:.4f} ms against planar "
        f"{planar_ms:.4f} ms in turns; kernel time [row-major, planar] "
        f"{json.dumps(own)}")
    q0 = FMParam()
    q0.V_dim = 0
    st0 = random_state(FMUpdater(q0), num_rows, dev, seed=3)
    tb0 = pack_state(st0)

    def pull0(state):
        return sweep_ms.sweep_pull_ms(state, sid, off, q0, block_rows=R)

    if not torch.equal(pull0(tb0), pull0(st0)):
        raise AssertionError("sweep_pull_rowmajor K=0 differs from sweep_pull")
    planar_ms, ms, own = in_turns(dev, lambda: pull0(st0),
                                  lambda: pull0(tb0), names)
    faster["pull K=0"] = no_slower(own)
    log(f"sweep_pull_rowmajor K=0: {ms:.4f} ms against sweep_pull "
        f"{planar_ms:.4f} ms; kernel time [row-major, planar] "
        f"{json.dumps(own)}")
    del tb, tb0

    # -- apply: every w/V updater pair, and K = 0 --------------------------
    vf = pb.valid.to(torch.float32)
    worst = {"sweep_apply": 0.0, "sweep_apply_rowmajor": 0.0}
    for k, wupd, vupd in UPDATER_CASES:
        k = k_main if k else 0
        q = FMParam()
        q.V_dim, q.w_updater, q.V_updater = k, wupd, vupd
        base = st if k else st0
        grads = torch.randn((1 + k, U), generator=g, device=dev) * vf
        payload = sweep_ms.apply_payload(grads, pb.ucounts, pb.valid)

        def apply(state, **kw):
            return sweep_ms.sweep_apply_ms(state, sid, payload, off, q,
                                           block_rows=R, **kw)

        a = apply(clone_state(base))
        b = sweep_ms.sweep_apply_ms_plain(clone_state(base), sid, payload,
                                          off, q, block_rows=R)
        c = unpack_state(apply(pack_state(base)))
        narrow = {v: unpack_state(sweep_ms._sweep_apply_rowmajor(
            pack_state(base), sid, payload, off, q, R, vec=v))
            for v in (1, 2)}
        for name in ("w", "z", "n", "cnt", "V", "nV"):
            x, y = getattr(a, name), getattr(b, name)
            if not x.numel():
                continue
            # the same sums in the same order and the same arithmetic as
            # the planar kernel: the same bits, whatever the piece width
            for what, got in [("", c)] + [(f" with {v}-float pieces", s_)
                                          for v, s_ in narrow.items()]:
                if not torch.equal(getattr(got, name), x):
                    raise AssertionError(
                        f"sweep_apply_rowmajor{what} {wupd}/{vupd} K={k} "
                        f"differs from sweep_apply: {name} (tolerance: "
                        "bit-equal)")
            for design, got in (("sweep_apply", x),
                                ("sweep_apply_rowmajor", getattr(c, name))):
                worst[design] = max(worst[design],
                                    float((got - y).abs().max()))
                # unique ids: the same sums; the plain version's division
                # by a scalar is a multiply by its reciprocal: 1 ulp
                torch.testing.assert_close(
                    got, y, rtol=1e-5, atol=1e-6,
                    msg=f"{design} {wupd}/{vupd} K={k}: {name}")
        del a, b, c, narrow
        act = past_gate(pb, base, q)
        # useful bytes as for apply_pairs, plus the offsets; a full sweep
        # reads and writes all 4 + 2k leaves of every row
        pay_io = 4 * (U + (nb + 1) + 3 * n_valid + k * act)
        nbytes = pay_io + updater_bytes(wupd, vupd, k, n_valid, act)
        whole = pay_io + 4 * 2 * (4 + 2 * k) * num_rows
        work, work_rm = clone_state(base), pack_state(base)
        planar_ms, ms, own = in_turns(dev, lambda: apply(work),
                                      lambda: apply(work_rm), names)
        rec = dict(
            planar_ms=planar_ms, rowmajor_ms=ms,
            plain_ms=cuda_ms(lambda: sweep_ms.sweep_apply_ms_plain(
                work, sid, payload, off, q, block_rows=R)),
        )
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 20 * n_valid
                                                 + 8 * k * act)
        rec["whole_table_ms"] = whole / HBM_BYTES_PER_S * 1e3
        faster[f"apply {wupd}/{vupd} K={k}"] = no_slower(own)
        log(f"sweep_apply {wupd}/{vupd} K={k} ({n_valid} named rows, {act} "
            f"past the V gate; a whole-table sweep moves {whole} B): "
            f"{json.dumps(rec)}; kernel time [row-major, planar] "
            f"{json.dumps(own)}")
        if (k, wupd, vupd) == (k_main, "ftrl", "adagrad"):  # the main path's
            for name, src, t, k_ms in (
                    ("sweep_apply", "difacto_tpu_torch/csrc/sweep_apply.cu",
                     planar_ms, own["warm"][1]),
                    ("sweep_apply_rowmajor", rm_src, ms, own["warm"][0])):
                out[name] = dict(
                    route="cuda", source=src,
                    replaces="difacto_tpu/ops/sweep_ms.py:320", ms=t,
                    plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                    bound_by=rec["bound_by"], library_ms=None, kernel_ms=k_ms)
        del work, work_rm
    for name, err in worst.items():
        out[name]["max_abs_err"] = err
    by_k = {f"K={k}": all(v for name, v in faster.items()
                          if name.endswith(f"K={k}")) for k in (k_main, 0)}
    log(f"row-major sweep kernels no slower than the planar ones by kernel "
        f"time, warm and cold: {json.dumps(faster)}; every case of one "
        f"width: {json.dumps(by_k)} (what parallel/store.py::_resolve_layout "
        "gives layout=auto with kernel=pallas follows this line)")
    if not all(by_k.values()):
        raise AssertionError("layout=auto puts kernel=pallas on the row-major "
                             "table, where a kernel is now slower than its "
                             f"planar one: {faster}")

    # -- two streams of repeated ids: the first 2^16 slots of two seeded
    # batches, each sorted with a sentinel tail; pull exact, and an
    # integer payload in [1, 8] through SGD with unit rates on a zero
    # table (w = -sum gw, V = -sum gV, cnt = sum add_cnt, all exact in
    # float32), so a slot lost or added twice fails
    slots = 1 << 16
    parts, offs, pos = [], [], 0
    for seed in (20, 21):
        ids = flagship_batch(seed).ids.reshape(-1)[:slots].astype(
            np.int64) % num_rows
        ids = np.r_[np.sort(ids), np.full(1000, num_rows)]
        offs.append(np.searchsorted(ids, np.arange(nb + 1) * R) + pos)
        parts.append(ids)
        pos += ids.shape[0]
    sid2 = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
    off2 = torch.from_numpy(np.stack(offs).astype(np.int32)).to(dev)
    ref = sweep_ms.sweep_pull_ms_plain(st, sid2, off2, p, block_rows=R)
    for what, state in (("sweep_pull", st),
                        ("sweep_pull_rowmajor", pack_state(st))):
        if not torch.equal(sweep_ms.sweep_pull_ms(state, sid2, off2, p,
                                                  block_rows=R), ref):
            raise AssertionError(f"{what} differs from its plain version on "
                                 "two streams of repeated ids")
    q = FMParam()
    q.V_dim, q.w_updater, q.V_updater, q.V_threshold = k_main, "sgd", "sgd", 0
    q.lr_eta, q.l2, q.V_lr_eta, q.V_l2 = 1.0, 0.0, 1.0, 0.0
    zero = FMUpdater(q).init_state(num_rows, 0, dev)
    zero.V.zero_()
    ipay = torch.randint(1, 9, (3 + k_main, sid2.shape[0]), generator=g,
                         device=dev).float()
    b = sweep_ms.sweep_apply_ms_plain(clone_state(zero), sid2, ipay, off2, q,
                                      block_rows=R)
    for what, a in (
            ("sweep_apply", sweep_ms.sweep_apply_ms(
                clone_state(zero), sid2, ipay, off2, q, block_rows=R)),
            ("sweep_apply_rowmajor", unpack_state(sweep_ms.sweep_apply_ms(
                pack_state(zero), sid2, ipay, off2, q, block_rows=R)))):
        for name in ("w", "z", "n", "cnt", "V", "nV"):
            if not torch.equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(
                    f"{what} differs from its plain version on two streams "
                    f"of an integer payload: {name} (tolerance: exact)")
    hot = int(torch.unique(sid2[sid2 < num_rows], return_counts=True)[1]
              .max())
    log(f"sweep kernels, both layouts, on 2 streams of {slots} slots "
        f"(hottest id {hot} slots over both): pull exact, integer-payload "
        "apply exact")
    del zero, a, b, ipay

    # -- a dense block: 900 of the 1024 rows of table block 7 named, every
    # other block empty; the row-major design has no per-block stage, the
    # planar one lists a full block
    rng = np.random.default_rng(22)
    ids = np.sort(rng.choice(R, size=900, replace=False)) + 7 * R
    sid3 = torch.from_numpy(np.r_[ids, np.full(124, num_rows)].astype(
        np.int32)).to(dev)
    off3 = sweep.offsets_1(sid3, num_rows, R)
    pay3 = torch.randn((3 + k_main, sid3.shape[0]), generator=g, device=dev)
    pay3[1 + k_main:] = (sid3 < num_rows).float()
    ref = sweep_ms.sweep_pull_ms_plain(st, sid3, off3, p, block_rows=R)
    if not torch.equal(sweep_ms.sweep_pull_ms(pack_state(st), sid3, off3, p,
                                              block_rows=R), ref):
        raise AssertionError("sweep_pull_rowmajor differs from its plain "
                             "version on a dense block")
    a = unpack_state(sweep_ms.sweep_apply_ms(pack_state(st), sid3, pay3, off3,
                                             p, block_rows=R))
    b = sweep_ms.sweep_apply_ms(clone_state(st), sid3, pay3, off3, p,
                                block_rows=R)
    for name in ("w", "z", "n", "cnt", "V", "nV"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"sweep_apply_rowmajor differs from "
                                 f"sweep_apply on a dense block: {name} "
                                 "(tolerance: bit-equal)")
    log("sweep kernels on a dense block (900 of 1024 rows named): row-major "
        "pull exact, row-major apply bit-equal to the planar one")
    return out


def check_probe_kernels(dev, pb, st, g, planar):
    """Phase 2, the probes' kernels (S1 packed pull/apply, S2 bisect, S3
    slot accumulate) at their probes' shapes; ``planar`` holds S1b's
    figures from :func:`planar_turns`. Returns their records."""
    import torch

    from difacto_tpu_torch.config import FMParam
    from difacto_tpu_torch.ops import pair_sweep
    from difacto_tpu_torch.probes import bench_slot_accum as sa
    from difacto_tpu_torch.probes import bisect_apply as bis
    from difacto_tpu_torch.probes import common
    from difacto_tpu_torch.probes import hw_packed_pairs as packed

    out = {}
    U = pb.uids.shape[0]
    n_valid = int(pb.valid.sum())
    p = FMParam()
    p.V_dim = K
    n_act = past_gate(pb, st, p)

    # -- S1a packed pull: exact against its plain version and against B1's
    # kernel on the unpacked state (a gather with a mask) -----------------
    A, B = packed.pack_state(st)
    got = packed.pull_packed(A, pb.uids, p)
    for what, ref in (("its plain version",
                       packed.pull_packed_plain(A, pb.uids, p)),
                      ("pull_pairs", pair_sweep.pull_pairs(st, pb.uids, p))):
        if not torch.equal(got, ref):
            raise AssertionError(f"pull_packed differs from {what} (max abs "
                                 f"err {float((got - ref).abs().max()):g}; "
                                 "tolerance: exact)")
    b_ms, b_by = bound(4 * (U + 2 * n_valid + K * n_act + (1 + K) * U), 0)
    # below ~0.03 ms the event time is the host's enqueue rate: the
    # kernel's own time, in turns with its floor readonly (the same loads,
    # no stores) and B1's, warm and flushed
    if packed.pull_packed(A, pb.uids, p, "readonly") is not None:
        raise AssertionError("pull_packed readonly returned an output")
    own = common.kernel_ms_in_turns(dev, {
        "pull_packed": lambda: packed.pull_packed(A, pb.uids, p),
        "readonly": lambda: packed.pull_packed(A, pb.uids, p, "readonly"),
        "pull_pairs": lambda: pair_sweep.pull_pairs(st, pb.uids, p)},
        ("pull_packed_kernel", "pull_pairs_kernel"))
    # the distinct 32-byte sectors the loads touch: w and cnt (two rows of
    # A) of the real ids, V (K rows) of the ids past the gate; the uids
    # are read coalesced
    real = pb.uids[pb.valid].long()
    gated = real[st.cnt[real] >= p.V_threshold]
    sectors = (2 * torch.unique(real // 8).numel()
               + K * torch.unique(gated // 8).numel())
    floor = dict(sectors=sectors, sector_floor_ms=(32 * sectors + 4 * U)
                 / HBM_BYTES_PER_S * 1e3)
    ratio = {temp: t["pull_packed"] / t["readonly"] for temp, t in own.items()}
    rate = {temp: sectors / t["readonly"] / 1e6 for temp, t in own.items()}
    log(f"pull_packed in turns with its floor readonly and pull_pairs, "
        f"kernel ms: {json.dumps(own)}; {json.dumps(floor)}; pull / "
        f"readonly {json.dumps(ratio)} (the row closes at <= 1.25 warm and "
        f"flushed: {all(r <= 1.25 for r in ratio.values())}); readonly "
        f"reads {json.dumps(rate)} G sectors/s")
    out["pull_packed"] = dict(
        route="cuda", source="difacto_tpu_torch/csrc/packed_pairs.cu",
        replaces="scripts/hw_packed_pairs.py:133", max_abs_err=0.0,
        ms=cuda_ms(lambda: packed.pull_packed(A, pb.uids, p)),
        plain_ms=cuda_ms(lambda: packed.pull_packed_plain(A, pb.uids, p)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        kernel_ms=own["warm"]["pull_packed"],
        kernel_ms_flushed=own["cold"]["pull_packed"],
        readonly_ms=own["warm"]["readonly"],
        readonly_ms_flushed=own["cold"]["readonly"],
        b1_kernel_ms=own["warm"]["pull_pairs"],
        b1_kernel_ms_flushed=own["cold"]["pull_pairs"],
    )

    # -- S1b packed apply (csrc/planar_apply.cu's entry over the rows of A
    # and B): the tolerance apply_pairs is held to against its plain
    # version, the bits of B2's kernel (both designs), and rmwonly leaves A
    # and B as they were ---------------------------------------------------
    vf = pb.valid.to(torch.float32)
    grads = torch.randn((1 + K, U), generator=g, device=dev) * vf
    payload = torch.cat([grads, (pb.ucounts * vf)[None], vf[None]])
    a2, b2 = packed.apply_packed(A.clone(), B.clone(), pb.uids, payload, p)
    ap, bp = packed.apply_packed_plain(A.clone(), B.clone(), pb.uids,
                                       payload, p)
    mine = packed.unpack_state(a2, b2)
    err = 0.0
    for leaf in LEAVES:
        x, y = getattr(mine, leaf), getattr(packed.unpack_state(ap, bp), leaf)
        err = max(err, float((x - y).abs().max()))
        torch.testing.assert_close(
            x, y, rtol=1e-5, atol=1e-6,
            msg=f"apply_packed against its plain version: {leaf}")
    b2_state = pair_sweep.apply_pairs(clone_state(st), pb.uids, payload, p)
    same_bits(mine, b2_state, "apply_packed", "apply_pairs")
    same_bits(packed.unpack_state(*packed.apply_packed(
        A.clone(), B.clone(), pb.uids, payload, p, stage="tiles")), b2_state,
        "apply_packed tiles", "apply_pairs")
    del b2_state
    a3, b3 = packed.apply_packed(A.clone(), B.clone(), pb.uids, payload, p,
                                 stage="rmwonly")
    same_bits(packed.unpack_state(a3, b3), st, "apply_packed rmwonly",
              "the state it was given")
    del ap, bp, a3, b3
    nbytes = (4 * (U + 3 * n_valid + K * n_act)
              + updater_bytes("ftrl", "adagrad", K, n_valid, n_act))
    b_ms, b_by = bound(nbytes, 20 * n_valid + 8 * K * n_act)
    # the default design is apply_pairs.cu's kernel handed the rows of A
    # and B by planar_apply.cu's entry
    out["apply_packed"] = dict(
        route="cuda", source="difacto_tpu_torch/csrc/apply_pairs.cu",
        replaces="scripts/hw_packed_pairs.py:197", max_abs_err=err,
        ms=cuda_ms(lambda: packed.apply_packed(a2, b2, pb.uids, payload, p)),
        plain_ms=cuda_ms(lambda: packed.apply_packed_plain(
            a2, b2, pb.uids, payload, p)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **planar,
    )
    del A, B, a2, b2

    # -- S2 bisect: the probe's stream (unique ids) for the times; a
    # stream of repeated ids with one hot id for the sums -----------------
    n = 1 << bis.N_LOG2
    rng = np.random.default_rng(6)
    sid, pay = bis.make_stream(rng, n, bis.U, dev)
    ids = np.sort(np.r_[rng.integers(0, n, 300000), np.full(500, 777)])
    sid_r = torch.from_numpy(np.r_[ids, np.full(1000, n)].astype(np.int32)
                             ).to(dev)
    nnz_r = sid_r.shape[0]
    pay_r = torch.randn((bis.PP, nnz_r), generator=g, device=dev)
    ipay_r = torch.randint(1, 9, (bis.PP, nnz_r), generator=g,
                           device=dev).float()
    w = torch.randn(n, generator=g, device=dev)
    seg_n = bis.row_sums(sid_r, torch.ones((1, nnz_r), dtype=torch.float64,
                                           device=dev), n)[0]
    got = bis.bisect_w(sid_r, pay_r, w)
    ref = w.double() + bis.row_sums(sid_r, pay_r[:1].double(), n)[0]
    tol = f64_sum_tolerance(
        seg_n + 1, w.abs().double()
        + bis.row_sums(sid_r, pay_r[:1].abs().double(), n)[0])
    diff = (got.double() - ref).abs()
    err_w = float(diff.max())
    if not bool((diff <= tol).all()):
        raise AssertionError("bisect_w differs from the float64 sums beyond "
                             f"the float32 summation bound (max {err_w:g})")
    iw = torch.randint(-8, 9, (n,), generator=g, device=dev).float()
    if not torch.equal(bis.bisect_w(sid_r, ipay_r, iw),
                       bis.bisect_w_plain(sid_r, ipay_r, iw)):
        raise AssertionError("bisect_w differs from its plain version on an "
                             "integer payload (tolerance: exact)")
    for variant in ("scanonly", "loadonly"):
        for s_, p_ in ((sid, pay), (sid_r, pay_r)):
            if not torch.equal(bis.bisect_w(s_, p_, w, variant), w):
                raise AssertionError(f"bisect_w {variant} changed w")
    # the first design sums each run in the same slot order: the same bits
    for s_, p_ in ((sid, pay), (sid_r, pay_r), (sid_r, ipay_r)):
        if not torch.equal(bis.bisect_w(s_, p_, w, "rowscan"),
                           bis.bisect_w(s_, p_, w)):
            raise AssertionError("bisect_w rowscan differs from the sparse "
                                 "design (tolerance: bit-equal)")
    log(f"bisect_w: {nnz_r} slots, hottest id {int(seg_n.max())} slots; max "
        f"abs err {err_w:g} against the float64 sums; integer payload "
        f"exact; scanonly and loadonly return w; rowscan gives the same bits")
    real = int((sid < n).sum())
    idx, pay0 = sid[:real].long(), pay[0, :real].contiguous()
    w_bytes = 4 * (sid.shape[0] + real + 2 * n)
    b_ms, b_by = bound(w_bytes, real + n)
    plain_ms = cuda_ms(lambda: bis.bisect_w_plain(sid, pay, w))
    library_ms = cuda_ms(lambda: w.index_add(0, idx, pay0))
    for name, variant in (("bisect_w", "highest"),
                          ("bisect_rowscan", "rowscan")):
        out[name] = dict(
            route="cuda", source="difacto_tpu_torch/csrc/bisect_apply.cu",
            replaces="scripts/bisect_apply.py:98", max_abs_err=err_w,
            ms=cuda_ms(lambda: bis.bisect_w(sid, pay, w, variant)),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms,
        )
    # these kernels take microseconds, so the event times above are the
    # host's enqueue rate; the stage split reads the kernels' own time
    stages = {v: common.kernel_ms(lambda: bis.bisect_w(sid, pay, w, v))
              for v in ("highest", "scanonly", "loadonly", "rowscan")}
    stages["index_add"] = common.kernel_ms(lambda: w.index_add(0, idx, pay0))
    stages["clone"] = common.kernel_ms(lambda: w.clone())  # the copy alone
    out["bisect_w"]["kernel_ms"] = stages["highest"]
    out["bisect_rowscan"]["kernel_ms"] = stages["rowscan"]
    log("bisect_w kernel time at the probe's shapes by torch.profiler "
        f"(ms): {json.dumps(stages)}")

    # bisect_ftrl4: the count leaf is a pure sum (float64 bound, exact on
    # integers, as n = sum g^2 from 0 is); w, z, n go through FTRL, whose
    # division by a scalar the plain version runs as a multiply by the
    # reciprocal: rtol 1e-5, atol 1e-6 as apply_pairs
    leaves = [torch.randn(n, generator=g, device=dev) * s_
              for s_ in (0.1, 1.0, 0.0, 0.0)]
    leaves[2] = torch.rand(n, generator=g, device=dev)
    leaves[3] = torch.randint(0, 4, (n,), generator=g, device=dev).float()
    got4 = bis.bisect_ftrl4(sid_r, pay_r, *leaves)
    ref4 = bis.bisect_ftrl4_plain(sid_r, pay_r, *leaves)
    err4 = 0.0
    for name, x, y in zip("wznc", got4, ref4):
        err4 = max(err4, float((x - y).abs().max()))
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6,
                                   msg=f"bisect_ftrl4: {name}")
    ref_c = leaves[3].double() + bis.row_sums(sid_r, pay_r[2:3].double(), n)[0]
    tol = f64_sum_tolerance(
        seg_n + 1, leaves[3].double()
        + bis.row_sums(sid_r, pay_r[2:3].abs().double(), n)[0])
    if not bool(((got4[3].double() - ref_c).abs() <= tol).all()):
        raise AssertionError("bisect_ftrl4: c differs from the float64 sums "
                             "beyond the float32 summation bound")
    zero = [torch.zeros(n, device=dev) for _ in range(4)]
    goti = bis.bisect_ftrl4(sid_r, ipay_r, *zero)
    refi = bis.bisect_ftrl4_plain(sid_r, ipay_r, *zero)
    for name, x, y in zip("wznc", goti, refi):
        if name in "nc" and not torch.equal(x, y):
            raise AssertionError(f"bisect_ftrl4 differs from its plain "
                                 f"version on an integer payload: {name} "
                                 "(tolerance: exact)")
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    inpl = [t.clone() for t in leaves]
    same = bis.bisect_ftrl4(sid_r, pay_r, *inpl, inplace=True)
    for name, x, y, z_ in zip("wznc", same, got4, inpl):
        if x is not z_ or not torch.equal(x, y):
            raise AssertionError(f"bisect_ftrl4 in place differs from out of "
                                 f"place: {name}")
    st4 = [torch.zeros(n, device=dev) for _ in range(4)]
    b_ms, b_by = bound(4 * (sid.shape[0] + 3 * real + 8 * n), 3 * real
                       + 20 * n)
    out["bisect_ftrl4"] = dict(
        route="cuda", source="difacto_tpu_torch/csrc/bisect_apply.cu",
        replaces="scripts/bisect_apply.py:190", max_abs_err=err4,
        ms=cuda_ms(lambda: bis.bisect_ftrl4(sid, pay, *st4)),
        plain_ms=cuda_ms(lambda: bis.bisect_ftrl4_plain(sid, pay, *st4)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    ftrl4 = {
        "in_place_ms": cuda_ms(lambda: bis.bisect_ftrl4(sid, pay, *st4,
                                                        inplace=True)),
        "kernel_ms": common.kernel_ms(lambda: bis.bisect_ftrl4(sid, pay,
                                                               *st4)),
        "kernel_in_place_ms": common.kernel_ms(lambda: bis.bisect_ftrl4(
            sid, pay, *st4, inplace=True)),
    }
    log(f"bisect_ftrl4 at the probe's shapes: {json.dumps(ftrl4)}")
    del sid_r, pay_r, ipay_r, leaves, got4, ref4, goti, refi, inpl, same

    # -- S3 slot accumulate: the probe's shapes; each row's ~512 slots
    # span several 128-slot chunks -----------------------------------------
    nslots = 1 << sa.LOG2
    ids = np.sort(rng.integers(0, sa.R, nslots)).astype(np.int32)
    ids[ids == 5] = 6                      # a row no slot names; 6 is hot
    sid3 = torch.from_numpy(ids).to(dev)
    pay3 = torch.randn((nslots, sa.PP), generator=g, device=dev)
    got = sa.slot_accum(sid3, pay3)
    ref = sa.slot_accum_plain(sid3, pay3.double())
    seg3 = torch.bincount(sid3.long(), minlength=sa.R).double()[:, None]
    tol = f64_sum_tolerance(seg3, sa.slot_accum_plain(sid3,
                                                      pay3.abs().double()))
    diff = (got.double() - ref).abs()
    err3 = float(diff.max())
    if not bool((diff <= tol).all()):
        raise AssertionError("slot_accum differs from the float64 sums "
                             f"beyond the float32 summation bound ({err3:g})")
    if not bool((got[5] == 0).all()):
        raise AssertionError("slot_accum: a row no slot names is not 0")
    ipay3 = torch.randint(1, 9, (nslots, sa.PP), generator=g,
                          device=dev).float()
    if not torch.equal(sa.slot_accum(sid3, ipay3),
                       sa.slot_accum_plain(sid3, ipay3)):
        raise AssertionError("slot_accum differs from its plain version on "
                             "an integer payload (tolerance: exact)")
    del ipay3
    log(f"slot_accum: {nslots} slots, hottest row {int(seg3.max())} slots; "
        f"max abs err {err3:g} against the float64 sums; integer payload "
        f"exact")
    sid3_l = sid3.long()
    acc = torch.zeros((sa.R, sa.PP), device=dev)
    b_ms, b_by = bound(4 * (nslots * sa.PP + nslots + sa.R * sa.PP),
                       nslots * sa.PP)
    own = common.kernel_ms_in_turns(dev, {
        "slot_accum": lambda: sa.slot_accum(sid3, pay3),
        "index_add_": lambda: acc.index_add_(0, sid3_l, pay3)},
        ("slot_accum", "index", "Memset"))
    log(f"slot_accum in turns with index_add_, kernel ms (each with its "
        f"memsets): {json.dumps(own)}")
    out["slot_accum"] = dict(
        route="cuda", source="difacto_tpu_torch/csrc/slot_accum.cu",
        replaces="scripts/bench_slot_accum.py:65", max_abs_err=err3,
        ms=cuda_ms(lambda: sa.slot_accum(sid3, pay3)),
        plain_ms=cuda_ms(lambda: sa.slot_accum_plain(sid3, pay3)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: acc.index_add_(0, sid3_l, pay3)),
        kernel_ms=own["warm"]["slot_accum"],
        kernel_ms_flushed=own["cold"]["slot_accum"],
    )
    return out


PROBE_KERNELS = ("apply_pairs2", "pull_packed", "apply_packed", "bisect_w",
                 "bisect_rowscan", "bisect_ftrl4", "slot_accum",
                 "segsum_chunks", "segsum_rows")


def drive_probes(dev) -> dict:
    """Phase 6: each probe's ``main`` in process at its full shapes. A
    probe that raises or returns non-zero fails the run. Returns the
    launch counts of the phase, every probe kernel's above 0."""
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.probes import (bench_slot_accum, bisect_apply,
                                          hw_apply2, hw_packed_pairs,
                                          segsum_designs)

    cuda.reset_launches()
    runs = [(hw_apply2, []), (hw_packed_pairs, []), (bench_slot_accum, []),
            (segsum_designs, [])]
    runs += [(bisect_apply, [v]) for v in (
        "highest", "default", "scanonly", "loadonly", "rowscan", "ftrl4",
        "ftrl4_inplace")]
    for mod, argv in runs:
        rc = mod.main(argv, device=dev)
        if rc != 0:
            raise AssertionError(f"probe {mod.__name__} {argv} returned {rc}")
    launches = dict(cuda.LAUNCHES)
    log(f"probes: launches {launches}")
    idle = [k for k in PROBE_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"the probes never launched {idle}")
    return launches


STEP_PATHS = ((), (("layout", "planar"),), (("layout", "packed"),),
              (("segsum", "scatter"),),
              (("layout", "packed"), ("segsum", "scatter")),
              (("kernel", "pallas"),),
              (("kernel", "pallas"), ("layout", "planar")),
              (("kernel", "pallas"), ("layout", "planar"),
               ("segsum", "sorted")),
              (("kernel", "pallas"), ("layout", "packed")),
              (("kernel", "pallas"), ("layout", "packed"),
               ("segsum", "sorted")),
              # the XLA path: each layout with either backward
              *((("kernel", "xla"), ("layout", lay), ("segsum", seg))
                for lay in ("stacked", "planar", "packed")
                for seg in ("sorted", "scatter")),
              # the hot/cold split at a small table
              (("hot_rows", "2048"),),
              (("hot_rows", "2048"), ("segsum", "scatter")),
              # device localize on xla and on the sweeps, and an overflow
              (("host_localize", "0"),),
              (("host_localize", "0"), ("kernel", "pallas")),
              (("host_localize", "0"), ("kernel", "pallas"),
               ("layout", "planar")),
              (("host_localize", "0"), ("unique_size", "2048")))


# FFM's step paths: the pairs path on either layout and backward, the
# sweep on either layout, the XLA path on each layout with either backward
FFM_STEP_PATHS = ((), (("layout", "planar"),), (("segsum", "scatter"),),
                  (("kernel", "pallas"),),
                  (("kernel", "pallas"), ("layout", "planar"),
                   ("segsum", "sorted")),
                  *((("kernel", "xla"), ("layout", lay), ("segsum", seg))
                    for lay in ("stacked", "planar", "packed")
                    for seg in ("sorted", "scatter")))


def check_step_against_cpu(dev, nnz: int = 16, model: tuple = (("V_dim",
                                                                "8"),),
                           paths: tuple = STEP_PATHS):
    """Phase 3: the device train and eval steps of every kernel path
    against the CPU plain path on a small batch of ``nnz`` slots a row,
    from one state (atol 2e-5, rtol 1e-5: sums differ in order between
    the kernels and index_add_). ``model`` is the loss's settings: the FM
    with K = 8, FFM at config 5's width or at K = 640, or FFM with
    explicit libffm fields (each row's slots a shuffle of the fields).
    A path with ``hot_rows`` splits the table by a remap of the batches'
    counts (the state carried in canonical rows, compared through the
    lut); one with ``host_localize=0`` steps on raw batches, localized on
    each device, and must count the same dropped ids (the rows of an
    overflowing batch's last lane, where its dropped ids alias, are held
    finite: they sum the dropped slots in the card's atomic order)."""
    import torch

    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data import remap
    from difacto_tpu_torch.data.batch_iter import Batch
    from difacto_tpu_torch.data.prep import prep_batch
    from difacto_tpu_torch.ops.localize import localize
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                    state_to_numpy)

    n = 1 << 14
    for extra in paths:
        cfg = Config.from_kwargs([("batch_size", "512"), ("num_bits", "14"),
                                  ("max_nnz_per_row", str(nnz)), *model,
                                  ("lr_eta", "0.1"), ("l1", "0.1"),
                                  ("V_lr_eta", "0.05"), ("V_threshold", "1"),
                                  *extra])
        upd = FMUpdater(cfg.effective_model_param())
        gpu = LocalStore(upd, cfg, device=dev)
        cpu = LocalStore(upd, cfg, device="cpu")
        rng = np.random.default_rng(5)
        nf = cfg.model.num_fields if cfg.expects_fields() else 0
        batches = []
        for s in range(4):
            ids = rng.integers(0, n, (512, nnz)).astype(np.int32)
            ids[rng.random((512, nnz)) < 0.1] = -1
            vals = np.where(ids < 0, 0, rng.normal(size=(512, nnz))).astype(
                np.float32)
            fields = (rng.random((512, nnz)).argsort(axis=1) % nf).astype(
                np.int32) if nf else None
            batches.append(Batch(ids, vals,
                                 (rng.random(512) > 0.5).astype(np.float32),
                                 np.ones(512, np.float32), fields))
        lut = None
        if gpu.hot_rows:
            lut = remap.build_remap(remap.count_sample(iter(batches), n, 4),
                                    gpu.hot_rows)
            gpu.set_remap(lut)
            cpu.set_remap(lut)
        sg = gpu.init_state(5)
        sc = cpu.place_state(state_from_numpy(state_to_numpy(sg, lut)))
        raw = not cfg.data.host_localize
        dropped = []

        def prep(b):
            return prep_batch(b, n, num_fields=nf, remap=lut,
                              hot_rows=gpu.hot_rows)

        for b in batches:
            if raw:
                sg, mg = gpu.train_step(sg, b.ids, b.vals, b.labels, b.mask,
                                        b.fields)
                sc, mc = cpu.train_step(sc, b.ids, b.vals, b.labels, b.mask,
                                        b.fields)
                dropped.append((float(mg.dropped_ids),
                                float(mc.dropped_ids)))
            else:
                sg, mg = gpu.train_step_prepped(sg, prep(b))
                sc, mc = cpu.train_step_prepped(sc, prep(b))
        if any(g != c for g, c in dropped):
            raise AssertionError(f"device localize {extra}: dropped ids "
                                 f"{dropped} (card, CPU)")
        # an overflowing batch's dropped ids alias its last lane, whose row
        # sums thousands of slots in the card's atomic order: held finite
        rest = np.ones(n, bool)
        for b in batches if raw else ():
            loc = localize(torch.from_numpy(b.ids), n, gpu.unique_size)
            if float(loc.overflow):
                rest[int(loc.uids[-1])] = False
        got, ref = state_to_numpy(sg, lut), state_to_numpy(sc, lut)
        for name in ("w", "z", "n", "V", "nV", "cnt"):
            if not np.isfinite(got[name]).all():
                raise AssertionError(f"device step {extra}: {name} is not "
                                     "finite")
            torch.testing.assert_close(
                torch.from_numpy(got[name][..., rest]),
                torch.from_numpy(ref[name][..., rest]),
                atol=2e-5, rtol=1e-5, msg=f"device step vs CPU {extra}: "
                f"{name}")
        if raw:
            _, pyg = gpu.eval_step(sg, b.ids, b.vals, b.labels, b.mask,
                                   b.fields)
            _, pyc = cpu.eval_step(sc, b.ids, b.vals, b.labels, b.mask,
                                   b.fields)
        else:
            _, pyg = gpu.eval_step_prepped(sg, prep(b))
            _, pyc = cpu.eval_step_prepped(sc, prep(b))
        torch.testing.assert_close(pyg.cpu(), pyc, atol=2e-5, rtol=1e-5)
        log(f"device train/eval steps {dict(model)} "
            f"{dict(extra) or 'kernel=auto'} match "
            f"the CPU plain path (4 steps, max |dw| "
            f"{float(np.abs(got['w'] - ref['w']).max()):g}"
            + (f", dropped ids {dropped}" if raw else "") + ")")


def split_step_bits(stacked, split, lut, host, b) -> None:
    """One train step of the stacked and the split table from one
    canonical state, the split fed the stacked step's per-key sums mapped
    to its lanes (canonical id -> remapped id -> lane): the pulled rows and
    the updated canonical state must hold the same bits. The split is a
    layout; only the per-key sums' association may differ in training."""
    import torch

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
    if not (torch.equal(pa.uids[pos][vb], canon[vb])
            and torch.equal(pa.ucounts[pos][vb], pb.ucounts[vb])
            and torch.equal(rows_a[pos][vb].view(torch.int32),
                            rows_b[vb].view(torch.int32))):
        raise AssertionError("the split's lanes do not pull the stacked "
                             "table's ids, counts and rows bit for bit")
    grads_b = torch.where(vb[None, :], grads_a[:, pos], 0.0)
    sa = stacked._apply(sa, la, grads_a, raw_a)
    sb = split._apply(sb, lb, grads_b, raw_b, halves)
    a, c = state_to_numpy(sa), state_to_numpy(sb, lut)
    for name in ("w", "z", "n", "V", "nV", "cnt"):
        if not np.array_equal(a[name].view(np.int32), c[name].view(np.int32)):
            raise AssertionError(f"one step: the split's canonical {name} "
                                 "differs from the stacked table's "
                                 "(tolerance: bit-equal)")


def check_hotcold_against_stacked(dev) -> None:
    """Phase 3: the hot/cold split against the stacked table on the card,
    from one carried state (canonical rows in, through the lut), Zipf ids.
    One step with the same per-key sums: the same bits
    (:func:`split_step_bits`). Four training steps on the sorted backward
    (FM's fused sums in B3's order, which repeat their bits): the same
    canonical state and margins within rtol 1e-4 / atol 1e-5, the JAX
    package's own tolerance for this comparison
    (tests/test_hotcold.py:149-153): the sums take a hot key's
    slots over other tile edges when the lanes are renumbered, and FTRL's
    accumulators of hot keys run to 1e5-1e6; the stacked table against
    the CPU's summation order likewise. Logs the largest differences."""
    import torch

    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data import remap
    from difacto_tpu_torch.data.batch_iter import Batch
    from difacto_tpu_torch.data.prep import prep_batch
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.probes import common
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.checkpoint import (state_from_numpy,
                                                    state_to_numpy)

    bits, H = 16, 4096
    n = 1 << bits
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(5):
        ids = common.zipf_ids(rng, 2048, NNZ, bits)
        batches.append(Batch(ids, np.where(ids < 0, 0.0, 1.0).astype(
            np.float32), (rng.random(2048) > 0.5).astype(np.float32),
            np.ones(2048, np.float32)))
    lut = remap.build_remap(remap.count_sample(iter(batches), n, 5), H)

    def worst(a, b):
        return {name: float(np.abs(a[name] - b[name]).max())
                for name in ("w", "z", "n", "V", "nV", "cnt")}

    base = [("batch_size", "2048"), ("num_bits", str(bits)),
            ("max_nnz_per_row", str(NNZ)), ("V_dim", str(K)),
            ("V_threshold", "1"), ("segsum", "sorted")]
    cfgs = [Config.from_kwargs(base + [("kernel", "xla")]),
            Config.from_kwargs(base + [("hot_rows", str(H))])]
    upd = FMUpdater(cfgs[0].model)
    stacked, split = (LocalStore(FMUpdater(c.model), c, device=dev)
                      for c in cfgs)
    exact = LocalStore(upd, cfgs[0], device="cpu")
    split.set_remap(lut)
    host = state_from_numpy(state_to_numpy(random_state(upd, n, dev, 22)))
    split_step_bits(stacked, split, lut, host, batches[0])
    sa, sb, sc = (store.place_state(host) for store in (stacked, split, exact))
    for b in batches[:4]:
        sa, _ = stacked.train_step_prepped(sa, prep_batch(b, n))
        sc, _ = exact.train_step_prepped(sc, prep_batch(b, n))
        sb, _ = split.train_step_prepped(sb, prep_batch(
            b, n, remap=lut, hot_rows=H))
    a, c, e = (state_to_numpy(sa), state_to_numpy(sb, lut),
               state_to_numpy(sc))
    for got, ref, what in ((c, a, "hot/cold against stacked"),
                           (a, e, "stacked against the CPU"),
                           (c, e, "hot/cold against the CPU")):
        for name in ("w", "z", "n", "V", "nV", "cnt"):
            torch.testing.assert_close(
                torch.from_numpy(got[name]), torch.from_numpy(ref[name]),
                atol=1e-5, rtol=1e-4, msg=f"{what}: {name}, largest "
                f"differences {worst(got, ref)}")
    _, p1 = stacked.eval_step_prepped(sa, prep_batch(batches[4], n))
    _, p2 = split.eval_step_prepped(sb, prep_batch(
        batches[4], n, remap=lut, hot_rows=H))
    torch.testing.assert_close(p2, p1, atol=1e-5, rtol=1e-4)
    log(f"hot/cold (H = {H} of 2^{bits}) = stacked on the card: one step "
        f"with the same per-key sums bit for bit; 4 steps (sorted): largest "
        f"differences {worst(c, a)}; stacked against the CPU {worst(a, e)}; "
        f"hot/cold against the CPU {worst(c, e)}")


def check_compact_step(dev) -> None:
    """Phase 3: the compact batch cache (``cache_compact``) at the
    flagship's shape on ``kernel=auto`` (pairs on the row-major table).
    The stream derived on the card from a compact batch's permutation
    (learners/step.py::derive_sorted_slots) equals the host's full form
    element for element and is monotone, its pads on the last real lane
    (the card's segment sums find segments by comparing adjacent lanes);
    one compact step and one full step from one state launch FM's fused
    per-key sums once each and leave the same table bits."""
    import torch

    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.learners.step import derive_sorted_slots
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.place import place_batch

    n = 1 << NUM_BITS
    b = flagship_batch(31)
    # the flagship's B*L is a whole number of 1024-slot tiles: a batch one
    # row short gives the stream pad slots
    cut = type(b)(*(None if a is None else a[:-1] for a in (
        b.ids, b.vals, b.labels, b.mask, b.fields)))
    for batch in (b, cut):
        pb = prep_batch(batch, n)
        full = place_batch(build_sorted_slots(pb.inv, pb.vals), dev)
        perm = build_sorted_slots(pb.inv, pb.vals, compact=True).slot_sorted
        derived = derive_sorted_slots(*(torch.from_numpy(a).to(dev) for a in (
            pb.vals, pb.inv, perm)))
        for got, name in zip(derived, ("x_sorted", "bidx", "inv_sorted")):
            ref = getattr(full, name)
            if got.dtype != ref.dtype or not torch.equal(
                    got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"compact: the {name} derived on the "
                                     "card is not the host's full form")
        lanes = derived[2]
        bl = pb.vals.size
        if not (bool((lanes[1:] >= lanes[:-1]).all())
                and bool((lanes[bl:] == lanes[bl - 1]).all())):
            raise AssertionError("compact: the derived lane stream is not "
                                 "monotone with its pads on the last lane")
    tables = []
    for compact in ("0", "1"):
        cfg = Config.from_kwargs([
            ("batch_size", str(BATCH)), ("num_bits", str(NUM_BITS)),
            ("max_nnz_per_row", str(NNZ)), ("V_dim", str(K)),
            ("V_threshold", "1"), ("cache_compact", compact)])
        upd = FMUpdater(cfg.model)
        store = LocalStore(upd, cfg, device=dev)
        st = store.place_state(random_state(upd, n, dev, 32))
        n0 = cuda.LAUNCHES["segsum_fm"], cuda.LAUNCHES["segsum_sorted"]
        step_pb = prep_batch(b, n)
        st, _ = store.train_step_prepped(st, step_pb)
        torch.cuda.synchronize()
        if (cuda.LAUNCHES["segsum_fm"] - n0[0],
                cuda.LAUNCHES["segsum_sorted"] - n0[1]) != (1, 0):
            raise AssertionError("compact: a step did not launch FM's fused "
                                 "per-key sums once (and B3 never)")
        if step_pb.sorted_slots.compact != (compact == "1"):
            raise AssertionError("compact: the store built the wrong form")
        tables.append(st.tbl)
    if not torch.equal(tables[0].view(torch.int32),
                       tables[1].view(torch.int32)):
        raise AssertionError("compact: the compact step's table is not the "
                             "full step's bit for bit")
    sorted_bytes = sum(getattr(full, k).nbytes
                       for k in ("x_sorted", "bidx", "inv_sorted"))
    log(f"compact step = full step bit for bit at the flagship "
        f"(kernel=auto, {store.layout}): derived stream equal and monotone "
        f"on the card at B*L {b.vals.size} and {bl} (BLp {lanes.shape[0]}); "
        f"sorted arrays {sorted_bytes} bytes a batch in full form, "
        f"{perm.nbytes} compact")


def device_profile(prof, wall_s: float, steps: int) -> dict:
    """Device time per step by kernel name from a torch.profiler trace of
    a replay epoch, and the device's idle share of the traced wall time
    (tracing itself slows the host, so the idle share is an upper bound)."""
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            by_name[e.key] = by_name.get(e.key, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    if busy_ms == 0:
        return {"device_time": "not measured (no device events traced)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "traced_wall_ms_per_step": wall_s / steps * 1e3,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "top_ms_per_step": [[k[:70], v / 1e3 / steps] for k, v in top],
    }


def write_zipf_libsvm(path: str, rows: int, seed: int, nnz: int = NNZ):
    from difacto_tpu_torch.probes import common

    rng = np.random.default_rng(seed)
    ids = common.zipf_ids(rng, rows, nnz, NUM_BITS)
    labels = (rng.random(rows) > 0.5).astype(np.int64)
    tok = [f"{i}:1" for i in ids.ravel().tolist()]
    with open(path, "w") as f:
        for r in range(rows):
            f.write(f"{labels[r]} {' '.join(tok[r * nnz:(r + 1) * nnz])}\n")


def write_main_data(tmp: str, model: dict) -> tuple[str, str]:
    """A model's train file (one epoch of MAIN_BATCHES batches) and its
    validation file (one batch)."""
    t0 = time.perf_counter()
    train = os.path.join(tmp, f"{model['name']}.svm")
    val = os.path.join(tmp, f"{model['name']}_val.svm")
    b, nnz, seed = model["batch"], model["nnz"], model["seed"]
    write_zipf_libsvm(train, MAIN_BATCHES * b, seed, nnz)
    write_zipf_libsvm(val, b, seed + 1, nnz)
    log(f"{model['name']} main path data written in "
        f"{time.perf_counter() - t0:.1f} s")
    return train, val


# the models the main paths train: the flagship FM and BASELINE config 5
FLAGSHIP = {"name": "flagship", "batch": BATCH, "nnz": NNZ, "seed": 10,
            "kw": (("batch_size", str(BATCH)), ("max_nnz_per_row", str(NNZ)),
                   ("V_dim", str(K)))}
FFM = {"name": "ffm", "batch": FFM_BATCH, "nnz": FFM_NNZ, "seed": 12,
       "kw": (("batch_size", str(FFM_BATCH)),
              ("max_nnz_per_row", str(FFM_NNZ)), ("V_dim", str(FFM_K)),
              ("loss", "ffm"))}

# the main paths: (config on top of the model's, the kernels each step
# launches, the pull first: it also serves the validation batch)
_PALLAS = (("kernel", "pallas"), ("segsum", "sorted"))
MAIN_PATHS = (
    ((("layout", "planar"),), PAIRS_KERNELS),
    ((("layout", "packed"),), ROWMAJOR_KERNELS),
    ((("kernel", "pallas"), ("layout", "planar")), SWEEP_KERNELS),
    # kernel=pallas as its defaults resolve: the row-major table
    # (layout=auto) and the scatter backward (segsum=auto)
    ((("kernel", "pallas"),), SWEEP_ROWMAJOR_KERNELS),
    ((*_PALLAS, ("layout", "planar")), SWEEP_SORTED_KERNELS),
    ((*_PALLAS, ("layout", "packed")), SWEEP_ROWMAJOR_SORTED_KERNELS),
    # the XLA path on the stacked table (layout=auto), the sorted sums by
    # segsum=auto
    ((("kernel", "xla"),), XLA_KERNELS),
    # device localize on the sweeps over the row-major table, with the
    # scatter backward (the raw-batch step's)
    ((("host_localize", "0"), ("kernel", "pallas")), SWEEP_ROWMAJOR_KERNELS),
)
# FFM as kernel=auto resolves it (the row-major table, the sorted
# backward), and over planar leaves
FFM_PATHS = (((), FFM_ROWMAJOR_KERNELS),
             ((("layout", "planar"),), FFM_PAIRS_KERNELS))


def drive_main_path(dev, train: str, val: str, extra: tuple, path: tuple,
                    model: dict = FLAGSHIP, note: dict | None = None,
                    inspect=None):
    """Phase 4: SGDLearner at ``model``'s full width on the kernel path
    that ``extra`` selects, which must launch each kernel of ``path`` once
    per step (the pull, its first kernel when it has one, also on the
    validation batch) and no other kernel. ``note`` joins the record, and
    so does ``inspect(learner)``'s dict, after the drive. The learner's
    construction is timed apart (``init_s``: with ``hot_rows``, the count
    sample and the remap). Returns (launch counts of the run, record)."""
    import torch

    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.ops import cuda

    cfg = Config.from_kwargs([
        ("data_in", train), ("data_val", val), ("num_bits", str(NUM_BITS)),
        *model["kw"], ("cache_batches", "1"), ("cache_on_device", "1"),
        ("report_interval", "0"), *extra,
    ])
    t0 = time.perf_counter()
    learner = SGDLearner(cfg)  # the card is the default device
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cuda.reset_launches()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    first = learner.train_epoch(0)  # streams the file, caches on the card
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    cache_fill = torch.cuda.memory_allocated(dev) - mem0
    t0 = time.perf_counter()
    timed = learner.train_epoch(1)  # replays the cached batches
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.train_epoch(2)  # the same replay, traced
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    va = learner.eval_pass(cfg.data.data_val)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    steps, batch = MAIN_BATCHES, model["batch"]
    rec = {
        "model": model["name"],
        "path": {"kernel": "auto", **dict(extra)},
        "kernel": learner.store.kernel,
        "layout": learner.store.layout,
        "init_s": t_init,
        "epoch0_stream_s": t_stream,
        # the device memory the train batch cache took (allocated bytes
        # over epoch 0, which fills it)
        "cache_fill_bytes": cache_fill,
        "replay_ms_per_step": t_replay / steps * 1e3,
        "replay_examples_per_s": batch * steps / t_replay,
        "train_logloss": [first.logloss, timed.logloss],
        "val_logloss": va.logloss, "val_exact_auc": va.exact_auc,
        "launches": launches,
        "profile": device_profile(prof, t_prof, steps),
        **(note or {}),
        **(inspect(learner) if inspect else {}),
    }
    log("main path: " + json.dumps(rec))
    for v in (first.logloss, timed.logloss, va.logloss):
        if not np.isfinite(v):
            raise AssertionError(f"non-finite logloss on the main path: {rec}")
    if first.num_examples != steps * batch or va.num_examples != batch:
        raise AssertionError(f"main path saw the wrong example count: {rec}")
    for name, t in vars(learner.state).items():  # the state's tensors
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite state {name}")
    # three train epochs of `steps` steps, then one validation batch that
    # pulls (the XLA path's pull is no kernel); no launch of another
    # path's kernels
    want = {name: 3 * steps if name in path else 0 for name in launches}
    if path[0] in PULL_KERNELS:
        want[path[0]] += 1
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} "
                             "(one per step and kernel)")
    return launches, rec


def conf_kw(name: str) -> tuple:
    """An example config's keys, less the data paths, ``model_out`` and
    ``max_num_epochs``, which each drive sets."""
    from difacto_tpu_torch.utils import arg_parser

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    return tuple((k, v) for k, v in arg_parser.read_file(path)
                 if k not in ("data_in", "data_val", "model_out",
                              "max_num_epochs"))


def to_parts(tmp: str, files: tuple) -> tuple[str, str]:
    """The port's converter on (train, val) libsvm text: the globs of
    their csr parts, as examples/fm_criteo.conf names them."""
    from difacto_tpu_torch.data import converter

    out = os.path.join(tmp, "csr")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    n = [len(converter.convert_file(f, os.path.join(out, os.path.basename(f))))
         for f in files]
    log(f"converter: {n} csr parts in {time.perf_counter() - t0:.2f} s")
    return tuple(os.path.join(out, os.path.basename(f)) + ".part*.npz"
                 for f in files)


def cli_train_predict(tmp: str, name: str, argv: list, val: str,
                      path: tuple) -> None:
    """CLI train (3 epochs, ``model_out``) on ``argv`` (an example config
    and its overrides), which must launch the kernels of ``path`` and no
    other table kernel, then ``task=predict`` on ``val`` with that
    checkpoint, on the card and on the CPU: the same scores (pred_out
    keeps 6 digits), finite. The CLI logs the predict AUC."""
    from difacto_tpu_torch import cli
    from difacto_tpu_torch.ops import cuda

    model = os.path.join(tmp, f"model_{name}")
    cuda.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "max_num_epochs=3", f"model_out={model}"])
    train_s = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(model + ".npz"):
        raise AssertionError(f"CLI train {name} failed (rc {rc})")
    launches = dict(cuda.LAUNCHES)
    if (min(launches[k] for k in path) == 0
            or any(launches[k] for k in TABLE_KERNELS - set(path))):
        raise AssertionError(f"the CLI run {name} went through the wrong "
                             f"kernels: {launches}")
    preds = {}
    for dev in (None, "cpu"):
        out = os.path.join(tmp, f"pred_{name}_{dev}.txt")
        rc = cli.main([*argv, f"data_in={val}", "task=predict",
                       f"model_in={model}", f"pred_out={out}"], device=dev)
        if rc != 0:
            raise AssertionError(f"CLI predict {name} failed (rc {rc})")
        preds[dev] = np.loadtxt(out)
    if not (preds[None].size and np.isfinite(preds[None]).all()):
        raise AssertionError(f"CLI predict {name}: no or non-finite scores")
    np.testing.assert_allclose(preds[None], preds["cpu"], rtol=2e-5,
                               atol=1e-5)
    log(f"CLI {name}: train 3 epochs {train_s:.1f} s, launches {launches}; "
        f"predict on the card = on the CPU over {preds[None].size} rows")


def drive_formats(dev, tmp: str, flagship_files: tuple, k156: dict,
                  libffm_loss_ms: float) -> None:
    """The data formats of the repo's example configs on the card, each
    at full width (8 batches, 3 epochs, one validation batch):

    P1  examples/fm_criteo.conf as written (csr parts, the flagship FM,
        FTRL/AdaGrad, the device batch cache) on the flagship data turned
        into parts by the port's converter, through SGDLearner (and the
        same keys on the text, for the stream time), then CLI train and
        ``task=predict`` on the parts;
    P2  FFM with explicit fields: Criteo in libffm form (39 fields, k = 4,
        K = 156, fields shuffled within each row) with examples/ffm.conf's
        updater settings, on the row-major table (``kernel=auto``) and on
        planar leaves, then CLI train and ``task=predict`` on the libffm
        files (launches into ``k156``);
    P3  P1 at examples/northstar.conf's config-4 table (2^26 rows), whose
        prep must take the native radix localizer; the prep's time on one
        batch by either engine.
    """
    from difacto_tpu_torch.data import _native, prep
    from difacto_tpu_torch.data.batch_iter import BatchIter
    from difacto_tpu_torch.data.synthetic import write_libffm

    # -- P1: csr parts at the flagship ------------------------------------
    criteo = {"name": "criteo_csr", "batch": BATCH, "nnz": NNZ, "seed": 10,
              "kw": conf_kw(CRITEO_CONF)}
    parts = to_parts(tmp, flagship_files)
    _, csr = drive_main_path(dev, *parts, (), ROWMAJOR_KERNELS, criteo)
    text = dict(criteo, name="criteo_text")
    _native.reset_runs()
    _, txt = drive_main_path(dev, *flagship_files, (("data_format", "libsvm"),),
                             ROWMAJOR_KERNELS, text)
    if not _native.RUNS["parse_native"] or _native.RUNS["parse_numpy"]:
        raise AssertionError(f"the text was not parsed by the native engine: "
                             f"{_native.RUNS}")
    log(f"P1 epoch0_stream_s: csr parts {csr['epoch0_stream_s']:.3f} s, "
        f"libsvm text {txt['epoch0_stream_s']:.3f} s (native parser); "
        f"replay ms a step {csr['replay_ms_per_step']:.3f} and "
        f"{txt['replay_ms_per_step']:.3f}")
    for key in ("train_logloss", "val_logloss", "val_exact_auc"):
        # the same rows in the same batches: the same floats
        if not np.allclose(csr[key], txt[key], rtol=1e-6, atol=0):
            raise AssertionError(f"csr parts and their text disagree on "
                                 f"{key}: {csr[key]} against {txt[key]}")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CRITEO_CONF)
    cli_train_predict(tmp, "criteo_csr", [conf, f"data_in={parts[0]}",
                                          f"data_val={parts[1]}"],
                      parts[1], ROWMAJOR_KERNELS)

    # -- P2: libffm with explicit fields at K = 156 -----------------------
    t0 = time.perf_counter()
    ffm_files = tuple(os.path.join(tmp, f"libffm_{w}.ffm")
                      for w in ("train", "val"))
    write_libffm(libffm_block(MAIN_BATCHES * LIBFFM_BATCH, 14), ffm_files[0])
    write_libffm(libffm_block(LIBFFM_BATCH, 15), ffm_files[1])
    log(f"libffm data written in {time.perf_counter() - t0:.1f} s")
    libffm = {"name": "libffm_criteo", "batch": LIBFFM_BATCH,
              "nnz": LIBFFM_FIELDS, "seed": 14,
              "kw": conf_kw(FFM_CONF) + (
                  ("data_format", "libffm"),
                  ("num_fields", str(LIBFFM_FIELDS)),
                  ("max_nnz_per_row", str(LIBFFM_FIELDS)))}
    runs = [drive_main_path(dev, *ffm_files, extra, path, libffm,
                            {"ffm_loss_grad_ms": libffm_loss_ms})
            for extra, path in FFM_PATHS]
    for (got, _), (_, path) in zip(runs, FFM_PATHS):
        for name in path:
            k156[name]["k156_launches"] = got[name]
    for key in ("train_logloss", "val_logloss", "val_exact_auc"):
        a, b = runs[0][1][key], runs[1][1][key]
        if not np.allclose(a, b, rtol=1e-6, atol=0):
            raise AssertionError(f"libffm FFM on the row-major table and on "
                                 f"planar leaves disagree on {key}: {a} "
                                 f"against {b}")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), FFM_CONF)
    # one checkpoint of the 5.3 GB table, at the end
    cli_train_predict(tmp, "libffm_criteo", [
        conf, "data_format=libffm", f"num_fields={LIBFFM_FIELDS}",
        f"max_nnz_per_row={LIBFFM_FIELDS}", f"data_in={ffm_files[0]}",
        f"data_val={ffm_files[1]}", "save_interval_epochs=3"], ffm_files[1],
        FFM_ROWMAJOR_KERNELS)

    # -- P3: the config-4 table, the native localizer ---------------------
    _native.reset_runs()
    drive_main_path(dev, *parts, (("num_bits", str(BIG_BITS)),),
                    ROWMAJOR_KERNELS, dict(criteo, name="criteo_csr_2^26"))
    runs3 = dict(_native.RUNS)
    if runs3["localize_native"] != MAIN_BATCHES + 1 or runs3[
            "localize_searchsorted"]:
        raise AssertionError(f"the prep at 2^{BIG_BITS} rows did not take the "
                             f"native localizer on every batch: {runs3}")
    b = next(iter(BatchIter(parts[0], BATCH, NNZ, BIG_BITS,
                            data_format="csr")))
    flat, n = b.ids.reshape(-1), 1 << BIG_BITS
    engines = {"native": lambda: _native.localize(flat, n),
               "numpy_searchsorted": lambda: prep._localize_numpy(flat, n)}
    for a, c in zip(*(fn() for fn in engines.values())):
        if not np.array_equal(a, c):
            raise AssertionError("the native localizer differs from NumPy's "
                                 f"on a 2^{BIG_BITS}-row batch")
    host_ms = dict.fromkeys(engines, 0.0)
    for name in list(engines) + list(engines)[::-1]:  # in turns
        t0 = time.perf_counter()
        for _ in range(5):
            engines[name]()
        host_ms[name] += (time.perf_counter() - t0) / 10 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        prep.prep_batch(b, n)
    prep_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"P3 prep at 2^{BIG_BITS} rows on the host CPU of the card's machine, "
        f"one {BATCH} x {NNZ} batch: localize ms {json.dumps(host_ms)} "
        f"(speedup {host_ms['numpy_searchsorted'] / host_ms['native']:.2f}x), "
        f"prep_batch {prep_ms:.2f} ms with the native engine; engine runs "
        f"{json.dumps(runs3)}")


NORTHSTAR_CONF = "examples/northstar.conf"  # BASELINE rows 3-4
# the generator's shape (examples/northstar_data.py:33-52): 39 fields of
# 60,000 Zipf-popular values a field, labels of a ground-truth FM
NORTHSTAR_FIELDS, NORTHSTAR_VOCAB = 39, 60_000


def write_northstar_parts(tmp: str) -> tuple[str, str]:
    """P4's data by the port's data/synthetic.py::make_ctr_data as csr
    parts (the keys examples/northstar_data.py writes): MAIN_BATCHES
    batches of the config's 16,384 rows to train, one to validate."""
    from difacto_tpu_torch.data.synthetic import make_ctr_data

    t0 = time.perf_counter()
    out = []
    for name, rows, seed in (("train", MAIN_BATCHES * BATCH, 1000),
                             ("val", BATCH, 9000)):
        blk = make_ctr_data(rows, num_fields=NORTHSTAR_FIELDS,
                            vocab_per_field=NORTHSTAR_VOCAB, seed=seed)
        path = os.path.join(tmp, f"northstar_{name}.part00000.npz")
        np.savez(path, labels=blk.labels, indptr=blk.indptr,
                 indices=blk.indices, values=blk.values)
        out.append(os.path.join(tmp, f"northstar_{name}.part*.npz"))
    log(f"P4 northstar-shaped csr parts written in "
        f"{time.perf_counter() - t0:.1f} s")
    return out[0], out[1]


def split_record(learner) -> dict:
    """P4's split: H, and each cached batch's share of its unique ids in
    the hot bucket; fails unless every batch, train and validation, was
    split."""
    items = [pb for _, batches in learner._batch_cache.values()
             for pb in batches]
    shares = []
    for pb in items:
        if pb.uids_hot is None:
            raise AssertionError("a P4 batch was not split")
        ch = pb.uids_hot.shape[0]
        shares.append(float(pb.valid[:ch].sum()) / float(pb.valid.sum()))
    if len(items) != MAIN_BATCHES + 1:
        raise AssertionError(f"P4 cached {len(items)} batches, expected "
                             f"{MAIN_BATCHES + 1}")
    return {"hot_rows": learner.store.hot_rows,
            "hot_share_of_uniques": shares}


def cache_record(learner) -> dict:
    """P4's batch cache: the device bytes of each cached train batch
    (summed tensor ``nbytes``), its sorted-slot arrays apart from the
    rest, averaged over the batches; fails unless every cached train
    batch lies on the card in the form ``cache_compact`` asks for."""
    import dataclasses

    import torch

    uri, compact = learner.cfg.data.data_in, learner.cfg.data.cache_compact
    items = [pb for key, (_, batches) in learner._batch_cache.items()
             if key.startswith(uri + "|") for pb in batches]

    def tensors(obj):
        return [t for t in (getattr(obj, f.name)
                            for f in dataclasses.fields(obj))
                if isinstance(t, torch.Tensor)]

    for pb in items:
        if pb.sorted_slots.compact != compact:
            raise AssertionError(f"P4 cached a batch of the wrong form "
                                 f"(cache_compact={int(compact)})")
        if any(t.device != learner.device
               for t in tensors(pb) + tensors(pb.sorted_slots)):
            raise AssertionError("P4 cached a batch off the card")
    if len(items) != MAIN_BATCHES:
        raise AssertionError(f"P4 cached {len(items)} train batches, "
                             f"expected {MAIN_BATCHES}")
    return {"cached_sorted_bytes_per_batch": sum(
                t.nbytes for pb in items
                for t in tensors(pb.sorted_slots)) / len(items),
            "cached_rest_bytes_per_batch": sum(
                t.nbytes for pb in items for t in tensors(pb)) / len(items)}


# P4's runs: the config as written (hot_rows=-1: the split, cache_compact=1:
# the compact batch cache), its twin with the full form, the stacked table
# alone, and the port's kernel=auto (pairs on the row-major table)
P4_RUNS = (("p4_hot", (), XLA_KERNELS),
           ("p4_hot_full", (("cache_compact", "0"),), XLA_KERNELS),
           ("p4_stacked", (("hot_rows", "0"), ("kernel", "xla")), XLA_KERNELS),
           ("p4_auto", (("hot_rows", "0"),), ROWMAJOR_KERNELS))
# the config's 6 M training rows (examples/northstar.conf,
# examples/northstar_data.py) in its batches of 16384
NORTHSTAR_TRAIN_BATCHES = -(-6_000_000 // BATCH)


def drive_config4(dev, tmp: str) -> dict:
    """P4: examples/northstar.conf at its config-4 settings
    (``num_bits=26 hot_rows=-1 cache_compact=1``), only its data paths,
    ``model_out`` and ``max_num_epochs`` overridden (``drive_main_path``
    trains 3 epochs and saves nothing), on northstar-shaped data; beside
    it the same keys with ``hot_rows=0 kernel=xla`` and with the port's
    ``kernel=auto``, and the config's twin with ``cache_compact=0``, which
    must end on the config's table bit for bit. Every batch of the split
    runs must be split, every step launch FM's fused per-key sums, and the
    split runs' cached
    batches lie on the card in their form (their bytes logged, and scaled
    to the config's 6 M rows by arithmetic). Returns {run: launch
    counts}."""
    import torch

    from difacto_tpu_torch.data import remap
    from difacto_tpu_torch.data.batch_iter import BatchIter

    files = write_northstar_parts(tmp)
    model = {"name": "northstar_2^26", "batch": BATCH,
             "nnz": NORTHSTAR_FIELDS, "seed": 1000,
             "kw": conf_kw(NORTHSTAR_CONF) + (
                 ("num_bits", str(BIG_BITS)), ("hot_rows", "-1"),
                 ("cache_compact", "1"))}
    out, recs, tables = {}, {}, {}

    def split_run(name):
        def inspect(learner):
            tables[name] = vars(learner.state)  # the final table's tensors
            return {**split_record(learner), **cache_record(learner)}
        return inspect

    for name, extra, path in P4_RUNS:
        out[name], recs[name] = drive_main_path(
            dev, *files, extra, path, dict(model, name=name),
            inspect=split_run(name) if name.startswith("p4_hot") else None)
        if name == "p4_hot_full":  # the compact cache: the same bits
            a, b = tables.pop("p4_hot"), tables.pop(name)
            for leaf in a:
                if not torch.equal(a[leaf].view(torch.int32),
                                   b[leaf].view(torch.int32)):
                    raise AssertionError(
                        f"P4: cache_compact=1 and cache_compact=0 end on "
                        f"different tables ({leaf})")
    summary = {name: {
        "kernel": r["kernel"], "layout": r["layout"],
        "epoch0_s": r["init_s"] + r["epoch0_stream_s"], "init_s": r["init_s"],
        "replay_ms_per_step": r["replay_ms_per_step"],
        "replay_examples_per_s": r["replay_examples_per_s"],
        "busy_ms": r["profile"].get("device_busy_ms_per_step"),
        "idle_share": r["profile"].get("device_idle_share"),
        "val_exact_auc": r["val_exact_auc"],
        **{k: r[k] for k in ("cached_sorted_bytes_per_batch",
                             "cached_rest_bytes_per_batch") if k in r},
        "cache_fill_bytes_per_batch": r["cache_fill_bytes"] / MAIN_BATCHES}
        for name, r in recs.items()}
    summary["p4_hot"]["table_bits_equal_to"] = "p4_hot_full"
    # the measured bytes a batch, times the config's batches: arithmetic
    scaled = {name: {
        "sorted_GB": summary[name]["cached_sorted_bytes_per_batch"]
        * NORTHSTAR_TRAIN_BATCHES / 1e9,
        "batch_GB": (summary[name]["cached_sorted_bytes_per_batch"]
                     + summary[name]["cached_rest_bytes_per_batch"])
        * NORTHSTAR_TRAIN_BATCHES / 1e9} for name in ("p4_hot", "p4_hot_full")}
    scaled["saved_GB"] = (scaled["p4_hot_full"]["batch_GB"]
                          - scaled["p4_hot"]["batch_GB"])
    shares = recs["p4_hot"]["hot_share_of_uniques"]
    H = recs["p4_hot"]["hot_rows"]
    # the split's set-up on the host: the count sample and the remap
    t0 = time.perf_counter()
    cnt = remap.count_sample(iter(BatchIter(files[0], BATCH, NORTHSTAR_FIELDS,
                                            BIG_BITS, data_format="csr")),
                             1 << BIG_BITS, 16)
    t1 = time.perf_counter()
    remap.build_remap(cnt, H)
    t2 = time.perf_counter()
    summary["p4_hot"].update(
        hot_rows=H, hot_share_train=shares[:-1], hot_share_val=shares[-1],
        count_sample_s=t1 - t0, build_remap_s=t2 - t1)
    log("P4 config 4 (2^26 rows): " + json.dumps(summary))
    log(f"P4 cache at the config's 6 M rows ({NORTHSTAR_TRAIN_BATCHES} "
        "batches; arithmetic on the bytes measured above, not a "
        "measurement): " + json.dumps(scaled))
    return out


BCD_CONF = "examples/bcd_linear.conf"  # the BCD learner's example config
# P5's depth: 2^20 training rows in four csr parts of 2^18 (the converter's
# default part), 2^16 validation rows; the card-against-CPU run on 2^14
BCD_PARTS, BCD_PART_ROWS = 4, 1 << 18
BCD_VAL_ROWS, BCD_SMALL_ROWS = 1 << 16, 1 << 14
# the CUDA function names of ROWMAJOR_KERNELS in a torch.profiler trace
TRACE_NAMES = {"pull_rowmajor": "rowmajor_pull_kernel",
               "segsum_fm": "fm_keysum_kernel",
               "apply_rowmajor": "rowmajor_apply_kernel"}


def write_bcd_parts(tmp: str) -> tuple[dict, int]:
    """P5's data by the port's make_ctr_data in the northstar generator's
    shape (39 fields of 60,000 values, FM-truth labels; a seed a part, as
    examples/northstar_data.py writes them) as csr parts: {name: glob}
    and the training parts' triplet count."""
    from difacto_tpu_torch.data.synthetic import make_ctr_data

    t0 = time.perf_counter()
    out, nnz = {}, 0
    for name, parts, rows, seed in (
            ("train", BCD_PARTS, BCD_PART_ROWS, 2000),
            ("val", 1, BCD_VAL_ROWS, 9100),
            ("small", 1, BCD_SMALL_ROWS, 2999)):
        for p in range(parts):
            blk = make_ctr_data(rows, num_fields=NORTHSTAR_FIELDS,
                                vocab_per_field=NORTHSTAR_VOCAB, seed=seed + p)
            np.savez(os.path.join(tmp, f"bcd_{name}.part{p:05d}.npz"),
                     labels=blk.labels, indptr=blk.indptr,
                     indices=blk.indices, values=blk.values)
            nnz += len(blk.indices) if name == "train" else 0
        out[name] = os.path.join(tmp, f"bcd_{name}.part*.npz")
    log(f"P5 csr parts written in {time.perf_counter() - t0:.1f} s "
        f"({BCD_PARTS * BCD_PART_ROWS} train rows, {nnz} triplets)")
    return out, nnz


def bcd_argv(data_in: str) -> list[str]:
    """examples/bcd_linear.conf as written, its data path replaced by csr
    parts (``data_format=csr``) and no ``model_out`` (each run sets it)."""
    from difacto_tpu_torch.utils import arg_parser

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), BCD_CONF)
    return [f"{k}={v}" for k, v in arg_parser.read_file(path)
            if k not in ("data_in", "model_out")] + [
        f"data_in={data_in}", "data_format=csr"]


def check_bcd_step(learner) -> dict:
    """The block step on the card against the CPU's on three blocks from
    one random (py, w): within rtol 1e-4 / atol 1e-5 (index_add_ adds
    atomically on the card; the CPU's float32 step stands within 0.19 of
    that bound of a float64 one at this size). Returns the largest
    differences."""
    import torch

    from difacto_tpu_torch.learners.bcd import block_step

    rng = np.random.default_rng(31)
    py0 = rng.normal(size=learner.py.shape[0]).astype(np.float32)
    w0 = (rng.normal(size=learner.num_rows) * 0.1).astype(np.float32)
    R, p = learner.rows_per_block, learner.cfg.model
    yy, mr = learner.yy.cpu(), learner.mr.cpu()
    worst = {"py": 0.0, "w": 0.0}
    for blk in (0, learner.num_blocks // 2, learner.num_blocks - 1):
        learner.py.copy_(torch.from_numpy(py0))
        learner.w.copy_(torch.from_numpy(w0))
        rows, cols, vals = learner.block_tensors(blk)
        learner.step(blk, rows, cols, vals)
        py, w = torch.from_numpy(py0.copy()), torch.from_numpy(
            w0[blk * R:(blk + 1) * R].copy())
        block_step(py, yy, mr, w, rows.cpu(), cols.cpu(), vals.cpu(), p.l1,
                   p.l2)
        for name, got, ref in (("py", learner.py, py),
                               ("w", learner.w[blk * R:(blk + 1) * R], w)):
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5,
                                       msg=f"BCD block {blk}: {name}")
            worst[name] = max(worst[name],
                              float((got.cpu() - ref).abs().max()))
    return worst


def drive_bcd(tmp: str) -> dict:
    """P5: examples/bcd_linear.conf (num_bits=22, batch 8192, 40 slots,
    V_dim=0, l1=1, l2=0.1, 5 epochs, 256 blocks) on 2^20 northstar-shaped
    rows, only ``data_in`` (csr parts), ``data_val``, ``model_out`` and
    ``bcd_tile_dir`` set: the tile store must hold every triplet, the block
    step match the CPU's, the run learn (train logloss falls, validation
    AUC above 0.6, nonzero w), a 2^14-row run match the CPU's w, and the
    CLI's train and task=predict (B1 at K = 0, nothing else; the CPU's
    scores). Returns {"launches": predict's, "model", "val"}."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from difacto_tpu_torch import cli
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.bcd import BCDLearner
    from difacto_tpu_torch.models.losses import stable_logloss
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.utils import arg_parser

    t0 = time.perf_counter()
    files, nnz = write_bcd_parts(tmp)
    data_s = time.perf_counter() - t0
    tiles = os.path.join(tmp, "bcd_tiles")
    model = os.path.join(tmp, "model_bcd")

    def config(*extra):
        return Config.from_kwargs(arg_parser.parse(
            bcd_argv(files["train"]) + list(extra)))

    cfg = config(f"data_val={files['val']}", f"model_out={model}",
                 f"bcd_tile_dir={tiles}")
    t0 = time.perf_counter()
    learner = BCDLearner(cfg)  # the card; the tile build
    tile_s = time.perf_counter() - t0
    held = int(np.load(os.path.join(tiles, "extents.npy")).sum())
    if held != nnz or learner.n != BCD_PARTS * BCD_PART_ROWS:
        raise AssertionError(f"the tile store holds {held} triplets of "
                             f"{learner.n} rows; the parts hold {nnz}")
    learner.reset()
    step_err = check_bcd_step(learner)
    epochs, clock = [], [0.0]

    def record(epoch, va):
        torch.cuda.synchronize()
        now = time.perf_counter()
        loss = stable_logloss(-learner.yy * learner.py) * learner.mr
        epochs.append({"epoch": epoch, "s": now - clock[0],
                       "train_logloss": float(loss.sum()) / learner.n,
                       "val_logloss": va.logloss,
                       "val_exact_auc": va.exact_auc, "nnz_w": va.nnz_w})
        clock[0] = now

    learner.epoch_callbacks.append(record)
    cuda.reset_launches()
    clock[0] = time.perf_counter()
    learner.run()
    if any(cuda.LAUNCHES.values()):
        raise AssertionError(f"the BCD step launched a table kernel: "
                             f"{cuda.LAUNCHES}")
    # one sweep timed, one traced (the epoch's block steps, no metrics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.sweep()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.sweep()
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    blocks = learner.num_blocks
    rec = {"rows": learner.n, "triplets": nnz, "blocks": blocks,
           "tile_nnz": learner.tiles.tile_nnz,
           "data_write_s": data_s, "tile_build_s": tile_s,
           "block_step_vs_cpu_max_abs": step_err, "epochs": epochs,
           "sweep_s": sweep_s, "block_step_ms": sweep_s / blocks * 1e3,
           "profile": device_profile(prof, t_prof, blocks)}
    del learner
    shutil.rmtree(tiles)
    first, last = epochs[0], epochs[-1]
    if not (len(epochs) == 5 and last["train_logloss"] < first["train_logloss"]
            and last["val_exact_auc"] > 0.6 and last["nnz_w"] > 0):
        raise AssertionError(f"P5 did not learn: {json.dumps(rec)}")
    # a 2^14-row run, one epoch, on the card and on the CPU
    small = {}
    for where in (None, "cpu"):
        lrn = BCDLearner(config(f"data_in={files['small']}",
                                "max_num_epochs=1"), device=where)
        lrn.run()
        small[where] = lrn.w.cpu()
        del lrn
    torch.testing.assert_close(small[None], small["cpu"], rtol=2e-4,
                               atol=2e-5, msg="P5 2^14 rows: w after one "
                               "epoch, card against CPU")
    rec["small_w_max_abs_vs_cpu"] = float((small[None] - small["cpu"]).abs()
                                          .max())
    # the CLI: train as the config is written, then task=predict on its
    # checkpoint (the SGD eval path: pairs over planar leaves at K = 0)
    cli_model = os.path.join(tmp, "model_bcd_cli")
    t0 = time.perf_counter()
    if cli.main(bcd_argv(files["train"]) + [f"model_out={cli_model}",
                                            f"bcd_tile_dir={tiles}"]) != 0:
        raise AssertionError("CLI learner=bcd train failed")
    rec["cli_train_s"] = time.perf_counter() - t0
    shutil.rmtree(tiles)
    preds = {}
    for where in (None, "cpu"):
        out = os.path.join(tmp, f"pred_bcd_{where}.txt")
        cuda.reset_launches()
        if cli.main(bcd_argv(files["val"]) + [
                "task=predict", f"model_in={cli_model}",
                f"pred_out={out}"], device=where) != 0:
            raise AssertionError("CLI task=predict on the BCD model failed")
        if where is None:
            launches = dict(cuda.LAUNCHES)
        preds[where] = np.loadtxt(out)
    batches = BCD_VAL_ROWS // 8192
    if launches["pull_pairs"] != batches or sum(launches.values()) != batches:
        raise AssertionError(f"predict on the BCD model launched {launches}, "
                             f"expected pull_pairs {batches} times alone")
    if not (preds[None].shape == (BCD_VAL_ROWS,)
            and np.isfinite(preds[None]).all()):
        raise AssertionError("CLI predict on the BCD model: wrong scores")
    np.testing.assert_allclose(preds[None], preds["cpu"], rtol=2e-5,
                               atol=1e-5)
    rec["predict_launches"] = launches
    log("P5 BCD (examples/bcd_linear.conf): " + json.dumps(rec))
    return {"launches": launches, "model": model, "val": files["val"]}


def drive_remote(tmp: str, flagship_files: tuple, bcd_val: str) -> dict:
    """P6: the flagship's CLI train (2 epochs) and task=predict on
    kernel=auto (row-major pairs, FM's fused sums) with every URI on
    memory://: data_in
    libsvm text read in two byte-range parts, data_val gzip text,
    model_out, model_in and pred_out; the same run on local files must
    give the same checkpoint and scores bit for bit. And a BCD tile build
    from memory:// csr parts equal to the local build, byte for byte.
    Returns the remote run's launch counts."""
    import filecmp
    import gzip

    import fsspec
    import torch

    from difacto_tpu_torch import cli
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.batch_iter import BatchIter
    from difacto_tpu_torch.data.io import expand_uri, open_uri
    from difacto_tpu_torch.data.tile_store import build_tiles
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.utils import arg_parser, checkpoint

    mem = fsspec.filesystem("memory")
    train, val = flagship_files
    val_gz = val + ".gz"
    with open(val, "rb") as f, open(val_gz, "wb") as g:
        g.write(gzip.compress(f.read()))
    for src, dst in ((train, "/p6/flagship.svm"),
                     (val_gz, "/p6/flagship_val.svm.gz")):
        with open(src, "rb") as f, mem.open(dst, "wb") as g:
            g.write(f.read())
    shape = [f"{k}={v}" for k, v in FLAGSHIP["kw"]] + [
        f"num_bits={NUM_BITS}", "num_parts_per_file=2", "report_interval=0"]
    roots = {"local": (train, val_gz, os.path.join(tmp, "model_p6"),
                       os.path.join(tmp, "pred_p6.txt")),
             "remote": ("memory://p6/flagship.svm",
                        "memory://p6/flagship_val.svm.gz",
                        "memory://p6/model", "memory://p6/pred.txt")}
    rec, got = {}, {}
    for where, (tr, va, model, pred) in roots.items():
        lrn = SGDLearner(Config.from_kwargs(arg_parser.parse(
            [f"data_in={tr}", *shape])))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lrn.train_epoch(0)
        torch.cuda.synchronize()
        rec[f"{where}_epoch0_stream_s"] = time.perf_counter() - t0
        del lrn
        cuda.reset_launches()
        t0 = time.perf_counter()
        if cli.main([f"data_in={tr}", f"data_val={va}", *shape,
                     "max_num_epochs=2", f"model_out={model}"]) != 0:
            raise AssertionError(f"P6 CLI train ({where}) failed")
        rec[f"{where}_cli_train_s"] = time.perf_counter() - t0
        if cli.main([f"data_in={va}", *shape, "task=predict",
                     f"model_in={model}", f"pred_out={pred}"]) != 0:
            raise AssertionError(f"P6 CLI predict ({where}) failed")
        launches = dict(cuda.LAUNCHES)
        if (min(launches[k] for k in ROWMAJOR_KERNELS) == 0
                or any(launches[k] for k in TABLE_KERNELS
                       - set(ROWMAJOR_KERNELS))):
            raise AssertionError(f"P6 ({where}) went through the wrong "
                                 f"kernels: {launches}")
        with open_uri(pred) as f:
            got[where] = (f.read(), checkpoint.load(model)[0])
        rec[f"{where}_launches"] = launches
    if got["local"][0] != got["remote"][0] or not got["local"][0]:
        raise AssertionError("P6: the remote run's scores differ from the "
                             "local run's")
    for name in LEAVES:
        if not torch.equal(getattr(got["local"][1], name),
                           getattr(got["remote"][1], name)):
            raise AssertionError(f"P6: the remote checkpoint's {name} "
                                 "differs from the local one's")
    # BCD's tile build from csr parts on memory://
    for path in expand_uri(bcd_val):
        with open(path, "rb") as f, mem.open(
                "/p6/bcd/" + os.path.basename(path), "wb") as g:
            g.write(f.read())
    names = ("row.i32", "col.i32", "val.f32", "offsets.npy", "extents.npy",
             "labels.npy", "tiles.json")
    t_build = {}
    for where, uri in (("local", bcd_val),
                       ("remote", "memory://p6/bcd/bcd_val.part*.npz")):
        t0 = time.perf_counter()
        build_tiles(lambda uri=uri: BatchIter(uri, 8192, 40, 22,
                                              data_format="csr"),
                    os.path.join(tmp, f"p6_tiles_{where}"), 1 << 22,
                    num_blocks=256, num_shards=1)
        t_build[where] = time.perf_counter() - t0
    _, bad, err = filecmp.cmpfiles(os.path.join(tmp, "p6_tiles_local"),
                                   os.path.join(tmp, "p6_tiles_remote"),
                                   names, shallow=False)
    if bad or err:
        raise AssertionError(f"P6: tiles from memory:// differ: {bad} {err}")
    rec["bcd_tile_build_s"] = t_build
    mem.rm("/p6", recursive=True)
    log("P6 remote IO (memory://, flagship CLI on kernel=auto): "
        + json.dumps(rec))
    return rec["remote_launches"]


def drive_trace_and_tools(tmp: str, flagship_files: tuple,
                          bcd_model: str) -> dict:
    """P7: the flagship through SGDLearner on kernel=auto with
    DIFACTO_PROFILE set: the first train epoch writes one torch.profiler
    trace that parses and names the kernels it launched, the second
    writes none; then dump_model and table_stats on P5's checkpoint and
    on P1's flagship checkpoint (the dump's rows are those with nonzero w
    or an active factor, occupancy the share of cnt > 0). Returns the
    traced run's launch counts."""
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.tools import dump_model, table_stats
    from difacto_tpu_torch.utils import checkpoint, tracing

    prof_dir = os.path.join(tmp, "trace")
    tracing.reset()
    os.environ["DIFACTO_PROFILE"] = prof_dir
    try:
        learner = SGDLearner(Config.from_kwargs([
            ("data_in", flagship_files[0]), ("num_bits", str(NUM_BITS)),
            *FLAGSHIP["kw"], ("report_interval", "0")]))
        cuda.reset_launches()
        timer = tracing.StepTimer()  # waits for the card at each read
        for epoch in range(2):  # the first region traced, the second not
            timer.start()
            learner.train_epoch(epoch)
            timer.stop()
        wall = timer.times
        launches = dict(cuda.LAUNCHES)
    finally:
        del os.environ["DIFACTO_PROFILE"]
    traces = os.listdir(prof_dir)
    if traces != ["train_epoch_0.pt.trace.json"]:
        raise AssertionError(f"DIFACTO_PROFILE wrote {traces}, expected one "
                             "trace of the first region")
    path = os.path.join(prof_dir, traces[0])
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    missing = [k for k, n in TRACE_NAMES.items()
               if not any(n in x for x in names)]
    if missing or any(launches[k] != 2 * MAIN_BATCHES
                      for k in ROWMAJOR_KERNELS):
        raise AssertionError(f"the trace lacks {missing}; launches "
                             f"{launches}")
    rec = {"traced_epoch_s": wall[0], "untraced_epoch_s": wall[1],
           "trace_mb": os.path.getsize(path) / 2**20, "launches": launches}
    for name, prefix in (("p5_bcd", bcd_model),
                         ("p1_flagship", os.path.join(tmp,
                                                      "model_criteo_csr"))):
        out = os.path.join(tmp, f"dump_{name}.txt")
        t0 = time.perf_counter()
        with open(out, "w") as f:
            n = dump_model.dump(prefix, f)
        t1 = time.perf_counter()
        stats = table_stats.stats(prefix, shards=8)
        t2 = time.perf_counter()
        state, _ = checkpoint.load(prefix)
        w, V, cnt = (getattr(state, k).numpy() for k in ("w", "V", "cnt"))
        keep = w != 0
        if V.shape[0]:
            keep |= (V != 0).any(axis=0) & (cnt > 0)
        with open(out) as f:
            lines = sum(1 for _ in f)
        if not (n == lines == int(keep.sum()) > 0
                and stats["occupancy"] == float((cnt > 0).mean())):
            raise AssertionError(f"tools on {name}: dumped {n} rows ({lines} "
                                 f"lines) of {int(keep.sum())}; occupancy "
                                 f"{stats['occupancy']}")
        rec[name] = {"dump_rows": n, "dump_s": t1 - t0,
                     "table_stats_s": t2 - t1,
                     "occupancy": stats["occupancy"]}
        os.remove(out)
    log("P7 tracing and tools: " + json.dumps(rec))
    return launches


# P8, the sharded store: (a) the flagship's CLI at S = 1 with store=sharded
# against store=local; (b) S = 2 and 3 gloo ranks sharing the card, each
# on the flagship's global batches, P8_STEPS prepped train steps, an eval
# and a count step on every path of P8_PATHS, held against LocalStore on
# the card (in rank 0) over the same batches from the same state
P8_STEPS = 8
P8_RANKS = (2, 3)
P8_PATHS = (("kernel=auto", ()), ("layout=planar", (("layout", "planar"),)),
            ("kernel=pallas", (("kernel", "pallas"),)))
# the JAX package's local-against-sharded tolerance
# (tests/test_store_equiv.py:55): the table rtol and atol 2e-4, logloss
# rtol 1e-4; its eval tolerance (rtol and atol 1e-5) on the scores
P8_TOL = dict(rtol=2e-4, atol=2e-4)


def p8_config(extra: tuple, store: str, S: int):
    from difacto_tpu_torch.config import Config

    return Config.from_kwargs([
        ("num_bits", str(NUM_BITS)), *FLAGSHIP["kw"], ("store", store),
        ("batch_size", str(p8_rows(S))),
        *((("num_shards", str(S)),) if store == "sharded" else ()), *extra])


def p8_rows(S: int) -> int:
    """The global batch's rows for S ranks: the flagship's 16384, and two
    empty rows (no ids, mask 0: no examples) at S = 3, which must divide
    them."""
    return -(-BATCH // S) * S


def p8_batches(S: int):
    """The P8_STEPS global flagship batches (Zipf(1.2) ids) and the count
    step's ids, padded with empty rows to p8_rows(S)."""
    from difacto_tpu_torch.data.batch_iter import Batch

    def pad(b):
        extra = p8_rows(S) - BATCH
        if not extra:
            return b
        z = np.zeros((extra, NNZ), np.float32)
        return Batch(np.concatenate([b.ids, np.full((extra, NNZ), -1,
                                                    np.int32)]),
                     np.concatenate([b.vals, z]),
                     np.concatenate([b.labels, z[:, 0]]),
                     np.concatenate([b.mask, z[:, 0]]))

    return ([pad(flagship_batch(60 + i)) for i in range(P8_STEPS)],
            pad(flagship_batch(70)).ids)


def p8_local_reference(extra: tuple, S: int, pbs, count_ids, seed: int):
    """LocalStore on the card over the same global batches (``pbs``,
    prepped for one table with their sorted slots, on the card) from the
    same start: per step (examples, logloss, dropped), the eval scores and
    the table after the count step (planar leaves on the card), and its
    median step ms."""
    import torch

    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater, unpack_state

    cfg = p8_config(extra, "local", S)
    store = LocalStore(FMUpdater(cfg.model), cfg)
    state = store.init_state(seed)
    metrics, times = [], []
    for pb in pbs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = store.train_step_prepped(state, pb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append([float(m.examples), float(m.logloss_sum),
                        float(m.dropped_ids)])
    _, py = store.eval_step_prepped(state, pbs[0])
    state = store.count_step(state, torch.from_numpy(count_ids).to(
        store.device))
    if store.layout == "packed":
        state = unpack_state(state)
    elif store.layout == "stacked":
        raise AssertionError("P8 runs no stacked table")
    return metrics, py, state, float(np.median(times[1:])) * 1e3


def p8_rank(out_dir: str, S: str) -> None:
    """One rank of P8 (b), run by difacto_tpu_torch.parallel.launch: the
    ShardedStore on the card over every path of P8_PATHS; rank 0 holds
    the gathered table, the metrics and the scores against LocalStore on
    the card and writes the record."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from difacto_tpu_torch.data.prep import (build_sorted_slots,
                                             build_sorted_slots_sharded,
                                             prep_batch, prep_batch_sharded)
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.parallel.store import ShardedStore
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.place import place_batch

    S, rank = int(S), dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    batches, count_ids = p8_batches(S)
    # every rank is handed the global batches, prepped over S groups with
    # their sorted slots and placed on the card once (every path replays
    # them; the scatter backward reads no slots); rank 0's reference
    # LocalStore gets them prepped for one table
    cfg0 = p8_config((), "sharded", S)  # the paths share the table's rows
    store0 = ShardedStore(FMUpdater(cfg0.model), cfg0)
    num_rows, dev = store0.num_rows, store0.device
    pbs, ref_pbs = [], []
    for b in batches:
        pb = prep_batch_sharded(b, num_rows, S)
        pb.sorted_slots = build_sorted_slots_sharded(pb)
        pbs.append(place_batch(pb, dev))
        if rank == 0:
            lp = prep_batch(b, 1 << NUM_BITS)
            lp.sorted_slots = build_sorted_slots(lp.inv, lp.vals)
            ref_pbs.append(place_batch(lp, dev))
    recs = {}
    for name, extra in P8_PATHS:
        cfg = p8_config(extra, "sharded", S)
        store = ShardedStore(FMUpdater(cfg.model), cfg)
        state = store.init_state(5)
        # the all_to_all's wall time (synchronized around each call)
        a2a = {"s": 0.0, "n": 0, "on": False}
        exchange = store.comm.all_to_all

        def timed_all_to_all(x):
            if not a2a["on"]:
                return exchange(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = exchange(x)
            torch.cuda.synchronize()
            a2a["s"] += time.perf_counter() - t0
            a2a["n"] += 1
            return y

        store.comm.all_to_all = timed_all_to_all
        metrics, times = [], []
        half = P8_STEPS // 2
        cuda.reset_launches()
        for i, pb in enumerate(pbs[:half]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = store.train_step_prepped(state, pb)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append([float(m.examples), float(m.logloss_sum),
                            float(m.dropped_ids)])
        a2a["on"] = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pb in pbs[half:]:
                state, m = store.train_step_prepped(state, pb)
                metrics.append([float(m.examples), float(m.logloss_sum),
                                float(m.dropped_ids)])
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        a2a["on"] = False
        em, py = store.eval_step_prepped(state, pbs[0])
        state = store.count_step(state, count_ids)
        torch.cuda.synchronize()
        launches = torch.tensor([cuda.LAUNCHES[k] for k in cuda.LAUNCHES],
                                dtype=torch.float64, device=store.device)
        store.comm.all_reduce(launches)
        prof_rec = device_profile(prof, t_prof, P8_STEPS - half)
        host = store.gather_state(state)
        if rank == 0:
            ref_m, ref_py, ref, local_ms = p8_local_reference(
                extra, S, ref_pbs, count_ids, 5)
            rec = p8_compare(name, S, store, metrics, em, py, host, ref_m,
                             ref_py, ref)
            rec.update({
                "kernel": store.kernel, "layout": store.layout,
                "rows_per_shard": store.rows_per_shard,
                "num_rows": store.num_rows,
                "step_ms": float(np.median(times[1:])) * 1e3,
                "local_step_ms": local_ms,
                "all_to_all_ms_per_step": a2a["s"] * 1e3 / (P8_STEPS - half),
                "all_to_all_calls_per_step": a2a["n"] / (P8_STEPS - half),
                "all_to_all_share_of_traced_step": a2a["s"] / t_prof,
                "profile": prof_rec,
                "launches": {k: int(v) for k, v in zip(
                    cuda.LAUNCHES, launches.tolist()) if v},
            })
            recs[name] = rec
        del state, host
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(out_dir, f"p8_s{S}.json"), "w") as f:
            json.dump(recs, f)


def p8_compare(name, S, store, metrics, em, py, host, ref_m, ref_py,
               ref) -> dict:
    """Rank 0's check of one P8 path: the summed metrics of every step and
    of the eval step, the scores, and the gathered table (its padding
    rows zero) against LocalStore's. Returns the errors."""
    import torch

    m, r = np.asarray(metrics), np.asarray(ref_m)
    if not (np.array_equal(m[:, 0], r[:, 0]) and not m[:, 2].any()
            and np.allclose(m[:, 1], r[:, 1], rtol=1e-4, atol=0)):
        raise AssertionError(f"P8 S={S} {name}: step metrics {m.tolist()} "
                             f"against LocalStore's {r.tolist()}")
    if float(em.dropped_ids) or float(em.examples) != BATCH:
        raise AssertionError(f"P8 S={S} {name}: eval metrics {em}")
    torch.testing.assert_close(py, ref_py, rtol=1e-5, atol=1e-5,
                               msg=f"P8 S={S} {name}: eval scores")
    errs, n = {}, ref.num_rows
    for leaf in LEAVES:
        got = getattr(host, leaf)
        pad = got[..., n:]
        if pad.numel() and bool((pad != 0).any()):
            raise AssertionError(f"P8 S={S} {name}: padding rows of {leaf} "
                                 "are not zero")
        x = got[..., :n].to(ref.device)
        y = getattr(ref, leaf)
        if y.numel():
            errs[leaf] = float((x - y).abs().max())
            torch.testing.assert_close(
                x, y, **P8_TOL, msg=f"P8 S={S} {name}: the gathered {leaf} "
                "against LocalStore's")
    return {"max_abs_err": errs,
            "logloss_rel_err": float(np.max(np.abs(m[:, 1] - r[:, 1])
                                            / np.abs(r[:, 1])))}


def drive_sharded(dev, tmp: str, flagship_files: tuple) -> dict:
    """P8. (a) The flagship's CLI train (3 epochs, ``model_out``) and
    ``task=predict`` with ``store=sharded`` at S = 1 on kernel=auto
    against ``store=local`` on the same data: the same kernels in the same
    order, so the checkpoints and the scores must be bit-equal. (b) S = 2
    and S = 3 gloo ranks on the card (p8_rank), the kernels built first in
    this process so that the ranks load one library. Returns the launches
    of each S's run (summed over its ranks and paths)."""
    from difacto_tpu_torch import cli
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.ops.metrics import exact_auc
    from difacto_tpu_torch.parallel.launch import run_ranks

    train, val = flagship_files
    argv = [f"data_in={train}", f"data_val={val}", f"num_bits={NUM_BITS}",
            *(f"{k}={v}" for k, v in FLAGSHIP["kw"]), "max_num_epochs=3",
            "report_interval=0"]
    got = {}
    for store in ("sharded", "local"):
        model = os.path.join(tmp, f"p8_{store}")
        pred = os.path.join(tmp, f"p8_{store}.txt")
        cuda.reset_launches()
        t0 = time.perf_counter()
        if cli.main([*argv, f"store={store}", f"model_out={model}"]) != 0:
            raise AssertionError(f"P8 CLI train store={store} failed")
        train_s = time.perf_counter() - t0
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if cli.main([*argv, f"store={store}", f"data_in={val}",
                     "task=predict", f"model_in={model}",
                     f"pred_out={pred}"]) != 0:
            raise AssertionError(f"P8 CLI predict store={store} failed")
        with np.load(model + ".npz") as z:
            got[store] = ({k: z[k] for k in LEAVES}, np.loadtxt(pred),
                          train_s, launches)
    (ms, ps, ts, ls), (ml, pl, tl, ll) = got["sharded"], got["local"]
    for leaf in LEAVES:
        if not np.array_equal(ms[leaf].view(np.int32),
                              ml[leaf].view(np.int32)):
            raise AssertionError(f"P8 (a): store=sharded's checkpoint differs "
                                 f"from store=local's in {leaf} (tolerance: "
                                 "bit-equal)")
    if not (ps.size == FLAGSHIP["batch"] and np.isfinite(ps).all()
            and np.array_equal(ps, pl)):
        raise AssertionError("P8 (a): store=sharded's scores differ from "
                             "store=local's (tolerance: bit-equal)")
    if ls != ll:
        raise AssertionError(f"P8 (a): store=sharded launched {ls}, "
                             f"store=local {ll}")
    from difacto_tpu_torch.data.libsvm import parse_libsvm

    with open(val, "rb") as f:
        labels = parse_libsvm(f.read()).labels
    log(f"P8 (a) CLI store=sharded at S = 1: train {ts:.2f} s (store=local "
        f"{tl:.2f} s), checkpoint and {ps.size} scores bit-equal to "
        f"store=local's, predict AUC {exact_auc(labels, ps):.6f}, launches "
        f"{ls}")
    cuda.build()  # once, before the ranks load it
    runs = {}
    for S in P8_RANKS:
        t0 = time.perf_counter()
        run_ranks("chip_smoke:p8_rank", S, [tmp, str(S)], timeout=300,
                  path=os.path.dirname(os.path.abspath(__file__)),
                  group_timeout=240)
        with open(os.path.join(tmp, f"p8_s{S}.json")) as f:
            recs = json.load(f)
        wall = time.perf_counter() - t0
        for name, rec in recs.items():
            log(f"P8 S={S} {name}: " + json.dumps(rec))
        runs[S] = {k: sum(r["launches"].get(k, 0) for r in recs.values())
                   for k in cuda.LAUNCHES}
        log(f"P8 S={S}: {S} ranks on one card, {len(recs)} paths held "
            f"against LocalStore in {wall:.1f} s; launches {runs[S]}")
        want = {"apply_rowmajor_segs", "apply_pairs_segs", MERGE,
                "sweep_apply_rowmajor"}
        if any(runs[S][k] == 0 for k in want):
            raise AssertionError(f"P8 S={S}: a kernel of the sharded paths "
                                 f"did not launch: {runs[S]}")
    return runs


# P9 the multi-process learner: the CLI under the env contract, one
# process a rank sharing the card, at the flagship's width (P6's libsvm
# text in byte-range parts, 8 global batches of 16384, 3 epochs, one
# validation batch), each launch under a timeout that kills every process
# still running past it
P9_TIMEOUT_S = 300.0
P9_GROUP_TIMEOUT_S = 180.0
P9_EPOCHS = 3
P9_TIMED_EPOCH, P9_TRACED_EPOCH = 1, 2  # epoch 0 streams untouched
P9_TOL = dict(rtol=2e-4, atol=2e-4)
# the SGD runs: (tag, processes, config on top of the flagship's, the
# kernels its steps launch)
P9_RUNS = (("a", 2, (), ("pull_rowmajor", "segsum_fm", MERGE,
                         "apply_rowmajor_segs")),
           ("c", 3, (("batch_size", str(3 * -(-BATCH // 3))),),
            ("pull_rowmajor", "segsum_fm", MERGE,
             "apply_rowmajor_segs")),
           ("d", 2, (("layout", "planar"),),
            ("pull_pairs", "segsum_fm", MERGE, "apply_pairs_segs")))
P9_KERNELS = ("pull_pairs", "pull_rowmajor", "segsum_fm",
              MERGE) + K1_KERNELS


class P9Probe:
    """Times a CLI run from inside its process, by wrapping the learners'
    and the collectives' entries for the run and restoring them after:
    each epoch's wall; in epoch P9_TIMED_EPOCH each train step
    (synchronized around), the all_to_alls and the host allgathers
    (synchronized around each call, as P8 times the exchange); epoch
    P9_TRACED_EPOCH under torch.profiler when ``traced``; BCD's block
    steps and their all_reduce. ``rec`` holds the numbers."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.rec = {"epoch_s": [], "step_ms": [], "a2a_s": 0.0,
                    "a2a_calls": 0, "allgather_s": 0.0, "allgather_calls": 0,
                    "allreduce_s": 0.0, "allreduce_calls": 0}
        self.on, self.steps = False, 0
        self.saved = []

    def _patch(self, owner, name, make):
        old = getattr(owner, name)
        self.saved.append((owner, name, old))
        setattr(owner, name, make(old))

    def _timed(self, key):
        import torch

        def make(fn):
            def run(*a, **kw):
                if not self.on:
                    return fn(*a, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.rec[key + "_s"] += time.perf_counter() - t0
                self.rec[key + "_calls"] += 1
                return out
            return run
        return make

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from difacto_tpu_torch.learners import bcd, sgd
        from difacto_tpu_torch.parallel import comm, store

        probe, rec = self, self.rec
        self._patch(comm.Comm, "all_to_all", self._timed("a2a"))
        for mod in (comm, store, sgd, bcd):
            self._patch(mod, "allgather_host", self._timed("allgather"))
        self._patch(bcd, "_all_reduce", self._timed("allreduce"))

        def epochs(fn):
            def run(learner, epoch):
                traced = probe.traced and epoch == P9_TRACED_EPOCH
                probe.on = epoch == P9_TIMED_EPOCH
                probe.steps = 0
                torch.cuda.synchronize()
                if traced:  # the wall inside the trace, as P8's
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        out = fn(learner, epoch)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                else:
                    t0 = time.perf_counter()
                    out = fn(learner, epoch)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                probe.on = False
                rec["epoch_s"].append(wall)
                rec["steps_per_epoch"] = probe.steps
                if traced:
                    rec["profile"] = device_profile(prof, wall,
                                                    max(probe.steps, 1))
                return out
            return run

        def steps(fn):
            def run(learner, *a):
                probe.steps += 1
                if not probe.on:
                    return fn(learner, *a)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(learner, *a)
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        def result(fn):
            def run(learner):
                last = fn(learner)
                rec["val_logloss"] = last.logloss
                rec["val_exact_auc"] = getattr(last, "exact_auc", None)
                return last
            return run

        self._patch(sgd.SGDLearner, "train_epoch", epochs)
        self._patch(sgd.SGDLearner, "_train_step", steps)
        self._patch(sgd.SGDLearner, "run", result)
        self._patch(bcd.BCDLearner, "train_epoch", epochs)
        self._patch(bcd.BCDLearner, "step", steps)
        self._patch(bcd.BCDLearner, "run", result)
        return rec

    def __exit__(self, *exc):
        for owner, name, old in reversed(self.saved):
            setattr(owner, name, old)
        return False


def p9_child(out_dir: str, tag: str, *argv: str) -> int:
    """One process of a P9 launch (started by run_processes under the env
    contract): the CLI's ``main`` on ``argv``, as ``python -m
    difacto_tpu_torch`` calls it, inside a P9Probe (rank 0 traced), with
    the launch counters reset just before; writes
    ``p9_{tag}_rank{p}.json``."""
    t0 = time.perf_counter()
    import torch

    from difacto_tpu_torch import cli
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, _ = multihost.maybe_initialize_distributed()
    with P9Probe(traced=rank == 0) as rec:
        cuda.reset_launches()
        rc = cli.main(list(argv))
        rec["launches"] = {k: v for k, v in cuda.LAUNCHES.items() if v}
    rec["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"p9_{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return rc


def p9_launch(tmp: str, tag: str, P: int, argv: list[str]) -> list[dict]:
    """Launch ``P`` processes of p9_child; returns each one's record."""
    from difacto_tpu_torch.parallel.launch import run_processes

    here = os.path.dirname(os.path.abspath(__file__))
    run_processes(["-c", "import sys, chip_smoke; sys.exit(chip_smoke."
                   "p9_child(*sys.argv[1:]))", tmp, tag, *argv], P,
                  timeout=P9_TIMEOUT_S, path=here,
                  group_timeout=P9_GROUP_TIMEOUT_S)
    recs = []
    for r in range(P):
        with open(os.path.join(tmp, f"p9_{tag}_rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def p9_launches(recs: list[dict], kernels: tuple, what: str,
                alone: bool = False) -> dict:
    """A run's launches summed over its processes; each of ``kernels``
    must have launched (and, ``alone``, nothing else)."""
    from difacto_tpu_torch.ops import cuda

    got = {k: sum(r["launches"].get(k, 0) for r in recs)
           for k in cuda.LAUNCHES}
    ran = {k for k, v in got.items() if v}
    if not ran >= set(kernels) or (alone and ran != set(kernels)):
        raise AssertionError(f"P9 {what}: launched {got}; the path's "
                             f"kernels are {kernels}")
    return got


def p9_reference(files: tuple, extra: tuple, P: int) -> dict:
    """LocalStore on the card fed the P processes' global stream
    (tests/test_multiprocess.py:135-199): each epoch the processes' part
    streams as the learner reads them (BatchIter over byte-range part p of
    P, its share of the batch, its shuffle seed), zipped, the shorter
    padded with empty batches, ``[p0 rows; p1 rows; ...]`` a step, prepped
    for one table with their sorted slots; then the validation pass.
    Returns the table's planar leaves, the validation logloss and exact
    AUC, the parts' batch counts and the median step ms."""
    import torch

    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.data.batch_iter import Batch, BatchIter
    from difacto_tpu_torch.data.prep import build_sorted_slots, prep_batch
    from difacto_tpu_torch.ops.metrics import exact_auc
    from difacto_tpu_torch.parallel.store import LocalStore
    from difacto_tpu_torch.updaters.updater import FMUpdater
    from difacto_tpu_torch.utils.checkpoint import state_to_numpy
    from difacto_tpu_torch.utils.place import place_batch

    cfg = Config.from_kwargs([("num_bits", str(NUM_BITS)), *FLAGSHIP["kw"],
                              *extra, ("store", "local")])
    d = cfg.data
    bs = d.batch_size // P
    store = LocalStore(FMUpdater(cfg.model), cfg)
    state = store.init_state(d.seed)
    empty = Batch(np.full((bs, NNZ), -1, np.int32),
                  np.zeros((bs, NNZ), np.float32), np.zeros(bs, np.float32),
                  np.zeros(bs, np.float32))

    def stream(uri: str, shuffle: bool, epoch: int):
        parts = [list(BatchIter(
            uri, batch_size=bs, max_nnz=d.max_nnz_per_row,
            num_bits=d.num_bits, data_format=d.data_format,
            part_index=range(p, p + 1), num_parts=P,
            shuffle=shuffle and d.shuffle, seed=d.seed + epoch,
            batch_workers=d.batch_workers)) for p in range(P)]
        n = max(len(s) for s in parts)
        out = []
        for i in range(n):
            step = [s[i] if i < len(s) else empty for s in parts]
            pb = prep_batch(Batch(*(np.concatenate([getattr(b, f)
                                                    for b in step])
                                    for f in ("ids", "vals", "labels",
                                              "mask"))), store.num_rows)
            pb.sorted_slots = build_sorted_slots(pb.inv, pb.vals)
            out.append(place_batch(pb, store.device))
        return out, [len(s) for s in parts]

    times, counts = [], {}
    for epoch in range(P9_EPOCHS):
        steps, counts["train"] = stream(files[0], True, epoch)
        for pb in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = store.train_step_prepped(state, pb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    loss, n, ys, ps = 0.0, 0.0, [], []
    steps, counts["val"] = stream(files[1], False, 0)
    for pb in steps:
        m, py = store.eval_step_prepped(state, pb)
        loss += float(m.logloss_sum)
        n += float(m.examples)
        keep = pb.mask.cpu().numpy() > 0
        ys.append(pb.labels.cpu().numpy()[keep])
        ps.append(py.cpu().numpy()[keep])
    return {"leaves": state_to_numpy(state), "val_logloss": loss / n,
            "val_exact_auc": exact_auc(np.concatenate(ys),
                                       np.concatenate(ps)),
            "part_batches": counts, "step_ms": float(np.median(times))}


def p9_summary(recs: list[dict]) -> dict:
    """Rank 0's epoch s and step ms, the shares of the timed epoch taken
    by the all_to_alls, the host allgathers and (BCD) the all_reduces,
    rank 0's traced epoch (busy ms a step, idle share), and each process's
    wall s."""
    r0 = recs[0]
    ep = r0["epoch_s"][P9_TIMED_EPOCH]
    out = {"epoch_s": r0["epoch_s"], "steps_per_epoch": r0["steps_per_epoch"],
           "step_ms_median": float(np.median(r0["step_ms"])),
           "step_ms_range": [min(r0["step_ms"]), max(r0["step_ms"])]}
    for key in ("a2a", "allgather", "allreduce"):
        if r0[key + "_calls"]:
            out[f"{key}_share_of_timed_epoch"] = r0[key + "_s"] / ep
            out[f"{key}_calls_per_step"] = (r0[key + "_calls"]
                                            / len(r0["step_ms"]))
    out["profile"] = r0.get("profile")
    out["wall_s"] = [r["wall_s"] for r in recs]
    return out


def p9_table(prefix: str, ref: dict, what: str) -> dict:
    """The per-process checkpoint, read by the port's load_full, against
    the reference's leaves (its padding rows zero). Returns the errors."""
    from difacto_tpu_torch.utils import checkpoint
    from difacto_tpu_torch.utils.checkpoint import state_to_numpy

    host, meta = checkpoint.load_full(prefix)
    got = state_to_numpy(host)
    errs = {}
    for leaf in LEAVES:
        want = ref[leaf]
        n = want.shape[-1]
        if got[leaf][..., n:].any():
            raise AssertionError(f"P9 {what}: padding rows of {leaf} are not "
                                 "zero")
        if want.size:
            errs[leaf] = float(np.abs(got[leaf][..., :n] - want).max())
            np.testing.assert_allclose(got[leaf][..., :n], want, **P9_TOL,
                                       err_msg=f"P9 {what}: {leaf}")
    return {"max_abs_err": errs, "process_count": meta["process_count"]}


def drive_multiprocess(tmp: str, flagship_files: tuple, smi: str) -> dict:
    """P9: the multi-process CLI, one process a rank sharing the card
    (kernels built first in this process, so that every process loads one
    library). (a) P = 2 on kernel=auto with validation and ``model_out``;
    (c) P = 3 at a global batch of 16386; (d) P = 2 on layout=planar: each
    held against LocalStore on the card over the same global stream (the
    checkpoint's leaves, read by the port's load_full, rtol and atol
    2e-4; the validation logloss rel 1e-5; the exact AUC abs 1e-5, the
    same on every process), its steps' kernels launched, and on (a) and
    (d) a step padded by the lockstep. (b) P = 2 task=predict on (a)'s
    checkpoint: the part files concatenate to a one-process predict of
    the file set loaded into LocalStore; B1 alone launches. (e) P = 2 BCD
    on examples/bcd_linear.conf over 2^18 of P5's rows: w against
    one-process BCD on the card (rtol and atol 2e-4). Returns each run's
    launches summed over its processes."""
    import torch

    from difacto_tpu_torch import cli
    from difacto_tpu_torch.config import Config
    from difacto_tpu_torch.learners.bcd import BCDLearner
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.utils import arg_parser, checkpoint

    t_p9 = time.perf_counter()
    cuda.build()  # once, before the processes load it
    train, val = flagship_files
    base = [f"data_in={train}", f"data_val={val}", f"num_bits={NUM_BITS}",
            *(f"{k}={v}" for k, v in FLAGSHIP["kw"]),
            f"max_num_epochs={P9_EPOCHS}", "report_interval=0"]
    # the one-process CLI on the same file, timed by the same probe
    t0 = time.perf_counter()
    with P9Probe(traced=True) as one:
        if cli.main(base + [f"model_out={os.path.join(tmp, 'p9_one')}"]) \
                != 0:
            raise AssertionError("P9: the one-process CLI train failed")
    one["wall_s"] = time.perf_counter() - t0
    one = p9_summary([one])
    log(f"P9 one process (the reference's times) on {smi}: "
        + json.dumps(one))
    launches = {}
    for tag, P, extra, kernels in P9_RUNS:
        model = os.path.join(tmp, f"p9_{tag}")
        argv = base + [f"{k}={v}" for k, v in extra] + [f"model_out={model}"]
        recs = p9_launch(tmp, tag, P, argv)
        ref = p9_reference(flagship_files, extra, P)
        what = f"({tag}) P={P} {dict(extra) or 'kernel=auto'}"
        rec = p9_table(model, ref["leaves"], what)
        aucs = {r["val_exact_auc"] for r in recs}
        if len(aucs) != 1:
            raise AssertionError(f"P9 {what}: the processes logged different "
                                 f"exact AUCs {aucs}")
        loss, auc = recs[0]["val_logloss"], recs[0]["val_exact_auc"]
        rel = abs(loss - ref["val_logloss"]) / ref["val_logloss"]
        if rel > 1e-5 or abs(auc - ref["val_exact_auc"]) > 1e-5:
            raise AssertionError(
                f"P9 {what}: validation logloss {loss} / exact AUC {auc} "
                f"against LocalStore's {ref['val_logloss']} / "
                f"{ref['val_exact_auc']} (rel 1e-5, abs 1e-5)")
        padded = len(set(ref["part_batches"]["train"])) > 1
        if tag in ("a", "d") and not padded:
            raise AssertionError(f"P9 {what}: equal parts "
                                 f"{ref['part_batches']}: no step padded")
        launches[tag] = got = p9_launches(recs, kernels, what)
        rec.update({"val_logloss": loss, "val_logloss_rel_err": rel,
                    "val_exact_auc": auc,
                    "val_exact_auc_abs_err": abs(auc - ref["val_exact_auc"]),
                    "part_batches": ref["part_batches"],
                    "local_store_step_ms": ref["step_ms"],
                    "launches": {k: v for k, v in got.items() if v},
                    **p9_summary(recs)})
        log(f"P9 {what} on {smi}: " + json.dumps(rec))
        del ref
        torch.cuda.empty_cache()
    # (b) predict on (a)'s file set, against one process
    pred = os.path.join(tmp, "p9_pred.txt")
    model = os.path.join(tmp, "p9_a")
    argv = base + ["task=predict", f"model_in={model}", f"data_in={val}",
                   f"pred_out={pred}"]
    recs = p9_launch(tmp, "b", 2, argv)
    launches["b"] = got = p9_launches(recs, ("pull_rowmajor",),
                                      "(b) P=2 task=predict", alone=True)
    parts = np.concatenate([np.loadtxt(f"{pred}.part{p}") for p in (0, 1)])
    one_pred = os.path.join(tmp, "p9_pred_one.txt")
    if cli.main(argv[:-1] + [f"pred_out={one_pred}"]) != 0:
        raise AssertionError("P9 (b): the one-process predict failed")
    ref = np.loadtxt(one_pred)
    if not (parts.shape == (BATCH,) and np.isfinite(parts).all()):
        raise AssertionError(f"P9 (b): {parts.shape} scores")
    np.testing.assert_allclose(parts, ref, **P9_TOL,
                               err_msg="P9 (b): the part files against one "
                               "process's predict")
    log(f"P9 (b) P=2 task=predict on {smi}: " + json.dumps({
        "scores": int(parts.size),
        "max_abs_err": float(np.abs(parts - ref).max()),
        "launches": {k: v for k, v in got.items() if v},
        "wall_s": [r["wall_s"] for r in recs]}))
    # (e) BCD over 2^18 of P5's rows
    part = os.path.join(tmp, "bcd_train.part00000.npz")
    bcd = bcd_argv(part) + [f"data_val={os.path.join(tmp, 'bcd_val.part00000.npz')}"]
    model = os.path.join(tmp, "p9_e")
    recs = p9_launch(tmp, "e", 2, bcd + [f"model_out={model}"])
    launches["e"] = p9_launches(recs, (), "(e) P=2 BCD", alone=True)
    t0 = time.perf_counter()
    with P9Probe(traced=False) as one_bcd:
        learner = BCDLearner(Config.from_kwargs(arg_parser.parse(bcd)))
        va = learner.run()
    one_bcd["wall_s"] = time.perf_counter() - t0
    w = learner.w.cpu().numpy()
    host, _ = checkpoint.load_full(model)
    err = float(np.abs(host.w.numpy() - w).max())
    np.testing.assert_allclose(host.w.numpy(), w, **P9_TOL,
                               err_msg="P9 (e): w against one process")
    if not np.count_nonzero(w):
        raise AssertionError("P9 (e): BCD learned nothing")
    if {r["val_exact_auc"] for r in recs} != {recs[0]["val_exact_auc"]}:
        raise AssertionError("P9 (e): the processes logged different AUCs")
    log(f"P9 (e) P=2 BCD (examples/bcd_linear.conf, 2^18 rows) on {smi}: "
        + json.dumps({"w_max_abs_err": err,
                      "nonzero_w": int(np.count_nonzero(w)),
                      "val_exact_auc": recs[0]["val_exact_auc"],
                      "one_process_val_exact_auc": va.exact_auc,
                      "one_process": p9_summary([one_bcd]),
                      **p9_summary(recs)}))
    log(f"P9: {time.perf_counter() - t_p9:.1f} s")
    return launches


def check_k1_launches(p8: dict, p9: dict) -> None:
    """Every K1 call of P8's and P9's runs launched one merge and counted
    once, under its K1 name: the merges equal the K1 counts in each run,
    and the search design (the yardstick) never ran."""
    for run, got in [(f"P8 S={S}", v) for S, v in p8.items()] + [
            (f"P9 ({tag})", v) for tag, v in p9.items()]:
        k1 = sum(got[name] for name in K1_KERNELS)
        if got[MERGE] != k1 or any(got[name] for name in K1_SEARCH):
            raise AssertionError(f"{run}: {got[MERGE]} merges for {k1} K1 "
                                 f"calls, search design "
                                 f"{[got[n] for n in K1_SEARCH]}")
    log("P8, P9: one merge a K1 call, no call of the search design")


def drive_cli(tmp: str) -> None:
    """Phase 5: on each table path, CLI train with validation and
    model_out, then task=predict on the checkpoint; the scores must match
    the CPU's. FFM (k = 4 on the set's 12 slots, 48 factors a feature) on
    the path ``kernel=auto`` resolves to."""
    from difacto_tpu_torch import cli
    from difacto_tpu_torch.data.synthetic import make_ctr_data, write_libsvm
    from difacto_tpu_torch.ops import cuda
    from difacto_tpu_torch.ops.metrics import exact_auc

    tr, va = os.path.join(tmp, "train.svm"), os.path.join(tmp, "val.svm")
    write_libsvm(make_ctr_data(8000, num_fields=10, vocab_per_field=300,
                               seed=1), tr)
    write_libsvm(make_ctr_data(2000, num_fields=10, vocab_per_field=300,
                               seed=2), va)
    labels = np.array([float(ln.split()[0]) for ln in open(va)])
    aucs = {}
    for kernel, layout, path, loss in (
            ("auto", "planar", PAIRS_KERNELS, "fm"),
            ("auto", "packed", ROWMAJOR_KERNELS, "fm"),
            ("pallas", "planar", SWEEP_KERNELS, "fm"),
            ("pallas", "packed", SWEEP_ROWMAJOR_KERNELS, "fm"),
            ("auto", "auto", FFM_ROWMAJOR_KERNELS, "ffm")):
        other = TABLE_KERNELS - set(path)
        model = os.path.join(tmp, f"model_{kernel}_{layout}_{loss}")
        shape = ["batch_size=512", "num_bits=16", "max_nnz_per_row=12",
                 "V_dim=8" if loss == "fm" else "V_dim=4", f"loss={loss}",
                 f"kernel={kernel}", f"layout={layout}"]
        cuda.reset_launches()
        rc = cli.main([f"data_in={tr}", f"data_val={va}", *shape,
                       "lr_eta=0.1", "l1=0.1", "V_lr_eta=0.05",
                       "max_num_epochs=2", f"model_out={model}"])
        if rc != 0 or not os.path.exists(model + ".npz"):
            raise AssertionError(f"CLI train kernel={kernel} layout={layout} "
                                 f"failed (rc {rc})")
        preds = {}
        for dev in (None, "cpu"):
            out = os.path.join(tmp, f"pred_{kernel}_{layout}_{loss}_{dev}.txt")
            rc = cli.main([f"data_in={va}", *shape, "task=predict",
                           f"model_in={model}", f"pred_out={out}"],
                          device=dev)
            if rc != 0:
                raise AssertionError(f"CLI predict kernel={kernel} "
                                     f"layout={layout} failed (rc {rc})")
            preds[dev] = np.loadtxt(out)
        # the path's kernels ran, the other path's did not
        if (min(cuda.LAUNCHES[k] for k in path) == 0
                or any(cuda.LAUNCHES[k] for k in other)):
            raise AssertionError(f"the CLI run loss={loss} kernel={kernel} "
                                 f"layout={layout} went through the wrong "
                                 f"kernels: {cuda.LAUNCHES}")
        auc = exact_auc(labels, preds[None])
        aucs[kernel, layout] = auc
        log(f"CLI loss={loss} kernel={kernel} layout={layout}: predict AUC "
            f"{auc:.6f} over {len(labels)} rows, launches "
            f"{dict(cuda.LAUNCHES)}")
        if not auc > 0.6:
            raise AssertionError(f"CLI validation AUC {auc} <= 0.6")
        np.testing.assert_allclose(preds[None], preds["cpu"], rtol=2e-5,
                                   atol=1e-5)
    # the two layouts of each table path train the same model (the verify
    # recipe's tolerance on AUC)
    for kernel in ("auto", "pallas"):
        if abs(aucs[kernel, "packed"] - aucs[kernel, "planar"]) > 1e-5:
            raise AssertionError(f"kernel={kernel}: layout=packed and "
                                 f"layout=planar disagree: {aucs}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from difacto_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    _, secs, ptxas = cuda.build(verbose=True)
    log(f"kernels built in {secs:.1f} s (nvcc, sm_90a)\n{ptxas}")
    cuda.library()
    from difacto_tpu_torch.data import _native

    t0 = time.perf_counter()
    if not _native.available():  # the native parser and localizer
        raise AssertionError(f"the native host engines did not build: "
                             f"{_native.build_error()}")
    log(f"native host engines built in {time.perf_counter() - t0:.1f} s "
        "(g++)")

    kernels = check_kernels(dev)
    kernels.update(check_k1_kernels(dev))
    k96, ffm_loss_ms = check_ffm_kernels(dev)
    k156, libffm_loss_ms = check_libffm_kernels(dev)
    k640 = check_wide_kernels(dev)
    if "--kernels-only" in sys.argv[1:]:  # a short first run of a new kernel
        log(json.dumps({"kernels_checked": sorted(kernels),
                        "k96_checked": sorted(k96),
                        "k156_checked": sorted(k156),
                        "k640_checked": sorted(k640)}))
        return 0
    check_step_against_cpu(dev)
    check_hotcold_against_stacked(dev)
    check_compact_step(dev)
    check_step_against_cpu(dev, FFM_NNZ, (("V_dim", str(FFM_K)),
                                          ("loss", "ffm")), FFM_STEP_PATHS)
    check_step_against_cpu(dev, LIBFFM_FIELDS, (
        ("V_dim", str(LIBFFM_K)), ("loss", "ffm"), ("data_format", "libffm"),
        ("num_fields", str(LIBFFM_FIELDS))), FFM_STEP_PATHS)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = flagship_files = write_main_data(tmp, FLAGSHIP)
        recs, by_path = {}, {}
        for extra, path in MAIN_PATHS:
            by_path[extra], recs[extra] = drive_main_path(dev, *files, extra,
                                                          path)
            launches.update({name: by_path[extra][name] for name in path})
        # the sweep trains the same model over either table layout. With
        # the sorted backward every kernel repeats its bits, so the metrics
        # are the same floats; the scatter backward's index_add_ adds
        # atomically, in another order each run: the verify recipe's
        # tolerance (logloss rel 1e-5, AUC abs 1e-5)
        for i, j, rtol, atol in ((2, 3, 1e-5, 1e-5), (4, 5, 1e-6, 0)):
            a, b = recs[MAIN_PATHS[i][0]], recs[MAIN_PATHS[j][0]]
            for key in ("train_logloss", "val_logloss", "val_exact_auc"):
                if not np.allclose(a[key], b[key], rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"kernel=pallas on the row-major table and on planar "
                        f"leaves disagree on {key}: {b['path']} {b[key]} "
                        f"against {a['path']} {a[key]}")
        # FFM at config 5's width, on the row-major table (what kernel=auto
        # resolves to) and on planar leaves: the sorted backward and
        # bit-equal kernels, so the same metric floats on both
        files = write_main_data(tmp, FFM)
        ffm = [drive_main_path(dev, *files, extra, path, FFM,
                               {"ffm_loss_grad_ms": ffm_loss_ms})
               for extra, path in FFM_PATHS]
        for (got, _), (_, path) in zip(ffm, FFM_PATHS):
            for name in path:
                k96[name]["k96_launches"] = got[name]
        # B3 runs on FFM's paths alone: its launches are theirs
        launches["segsum_sorted"] = sum(got["segsum_sorted"] for got, _ in ffm)
        for key in ("train_logloss", "val_logloss", "val_exact_auc"):
            a, b = ffm[0][1][key], ffm[1][1][key]
            if not np.allclose(a, b, rtol=1e-6, atol=0):
                raise AssertionError(f"FFM on the row-major table and on "
                                     f"planar leaves disagree on {key}: {a} "
                                     f"against {b}")
        drive_formats(dev, tmp, flagship_files, k156, libffm_loss_ms)
        # the new paths' launches, for the kernels line
        new_paths = {"xla": by_path[MAIN_PATHS[-2][0]],
                     "device_localize": by_path[MAIN_PATHS[-1][0]],
                     **drive_config4(dev, tmp)}
        # P5 BCD (its predict launches B1), P6 remote IO, P7 tracing and
        # the tools (row-major pairs and FM's fused sums)
        bcd = drive_bcd(tmp)
        new_paths["p5_bcd_predict"] = bcd["launches"]
        new_paths["p6_remote"] = drive_remote(tmp, flagship_files,
                                              bcd["val"])
        new_paths["p7_traced"] = drive_trace_and_tools(tmp, flagship_files,
                                                       bcd["model"])
        # P8 the sharded store: K1's and the merge's launches are its S = 2
        # and 3 runs'
        p8 = drive_sharded(dev, tmp, flagship_files)
        for S, got in p8.items():
            new_paths[f"p8_s{S}"] = got
        launches.update({name: sum(got[name] for got in p8.values())
                         for name in K1_KERNELS + (MERGE,)})
        # P9 the multi-process learner: K1's launches gain its runs'
        p9 = drive_multiprocess(tmp, flagship_files, smi)
        launches.update({name: launches[name] + sum(
            got[name] for got in p9.values())
            for name in K1_KERNELS + (MERGE,)})
        check_k1_launches(p8, p9)
        drive_cli(tmp)
    probed = drive_probes(dev)
    launches.update({name: probed[name] for name in PROBE_KERNELS})
    rows = [{"name": name, **{k: kernels[name][k] for k in (
        "route", "source", "replaces")}, "launches": launches[name],
        **{k: kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
        # the kernel's own time by torch.profiler, for the kernels short
        # enough that `ms` (CUDA events) is the host's enqueue rate; for
        # the planar apply, flushed too, the tiles and their rmwonly floor
        # and B2's time in the same turns; S1a's floor; at FFM's width, at
        # libffm Criteo's and at K = 640
        **{k: v for k, v in kernels[name].items() if k in EXTRA_KEYS},
        # K1 and the merge: the segments of their figures (S = 2), their
        # figures at S = 4, the search design's times in the same turns
        **{k: v for k, v in kernels[name].items()
           if name in K1_KERNELS + (MERGE,) and k in K1_KEYS},
        **{k: v for width in (k96, k156, k640)
           for k, v in width.get(name, {}).items()
           if k in K96_KEYS + K156_KEYS + K640_KEYS},
        # B1, FM's fused sums, the sweeps (B4, B5) and the row-major
        # kernels: their
        # launches on the paths of the XLA table, device localize, P4,
        # P5's predict, P6 and P7
        **({"new_path_launches": {run: got[name]
                                  for run, got in new_paths.items()}}
           if name in NEW_PATH_KERNELS else {}),
        # B1, FM's fused sums and K1: their launches in P9's runs, summed
        # over each
        # run's processes
        **({"p9_launches": {tag: got[name] for tag, got in p9.items()}}
           if name in P9_KERNELS else {})}
        for name in PAIRS_KERNELS + ("segsum_sorted", "pull_rowmajor",
                                     "apply_rowmajor")
        + SWEEP_KERNELS + SWEEP_ROWMAJOR_KERNELS + PROBE_KERNELS
        + K1_KERNELS + (MERGE,)]
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
