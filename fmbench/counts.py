"""The yardstick's operation and byte counts, and the card's peaks.

Each count is of what the work needs, from a batch's inputs alone: the
slots ``S = B * L``, the rows ``B``, the distinct table rows ``n`` the batch
touches, the factor width ``K`` (``F * k`` for a field-aware FM) and, for
FFM, the fields ``F``. Any implementation of the same step reads the same
count. What is shared lives here; a model's whole step and which kernels
it runs are its module's (``fmbench/models/<model>.py``: ``shape``,
``step_bytes``, ``step_flops``, ``KERNELS``). Every table row the step
updates is past the V gate in a measured window: a replayed batch's rows
were counted in the two epochs before it.

The kernels' bytes follow the repository's "useful bytes" of PERF.md's
kernel table (``chip_smoke.py``), with the lanes of a batch's unique bucket
taken as its distinct rows and its padded slot stream as its slots: each
input byte read once, each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks (NVIDIA's H100 datasheet):
# HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

F = 4  # bytes of a float32 or an int32


def pull_bytes(n: int, K: int) -> int:
    """B1: per row its id, w and cnt, V past the gate; out ``1 + K``."""
    return F * (n + 2 * n + K * n + (1 + K) * n)


def segsum_bytes(slots: int, n: int, pp: int) -> int:
    """B3: a ``pp``-row payload and a lane a slot in; ``pp`` sums a row
    out."""
    return F * (pp * slots + slots + pp * n)


def apply_bytes(n: int, K: int) -> int:
    """B2: per row its id, the w gradient, count and touch flag, the V
    gradient; read and written, FTRL's w, z, n, the count, and AdaGrad's
    V and nV."""
    return F * (n + 3 * n + K * n) + 2 * F * (4 * n + 2 * K * n)


def fm_keysum_bytes(slots: int, B: int, n: int, K: int) -> int:
    """FM's fused per-key sums (``fm_keysum_kernel`` and ``fm_keysum_join``,
    chip_smoke.py's ``check_segsum_fm``): ``4 (3 blp + B (1 + K) + K touched
    + (1 + K) U)``, a lane, a value and a row index a slot in, each row's
    ``d`` and ``S`` once, the touched lanes' pulled factors, ``1 + K`` sums
    a lane out. From a batch's inputs: the padded slot stream ``blp`` is
    taken as its slots, and both the valid lanes ``touched`` and the
    padded bucket lanes ``U`` as its distinct rows ``n``."""
    return F * (3 * slots + B * (1 + K) + K * n + (1 + K) * n)


def step_bytes(B: int, L: int, n: int, K: int, fields: bool) -> int:
    """The whole step's least traffic: the batch's slots (a lane and a
    value each, a field with FFM), labels and mask, its distinct rows' ids
    and counts, and each touched table row (w, z, n, cnt, V, nV) read and
    written once."""
    S = B * L
    return F * (S * (3 if fields else 2) + 2 * B + 2 * n) + 2 * F * (
        4 + 2 * K) * n


def update_flops(n: int, K: int) -> int:
    """The updaters' operations on ``n`` touched rows: FTRL about 15 a
    row, AdaGrad about 8 a factor."""
    return n * (15 + 8 * K)


def least_time_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The larger of the byte and the operation bound, and which it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")
