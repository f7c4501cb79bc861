"""The yardstick's operation and byte counts, and the card's peaks.

Each count is of what the work needs, from a batch's inputs alone: the
slots ``S = B * L``, the rows ``B``, the distinct table rows ``n`` the batch
touches, the factor width ``K`` (``F * k`` for a field-aware FM) and, for
FFM, the fields ``F``. Any implementation of the same step reads the same
count. Every table row the step updates is past the V gate in a measured
window: a replayed batch's rows were counted in the two epochs before it.

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


def payload_rows(loss: str, K: int) -> int:
    """B3's payload rows on the sorted backward: FM sums ``dw``, ``dw x``
    and ``dw S`` (2 + K), FFM each slot's gradient row (1 + K)."""
    return 1 + K if loss == "ffm" else 2 + K


def step_bytes(B: int, L: int, n: int, K: int, fields: bool) -> int:
    """The whole step's least traffic: the batch's slots (a lane and a
    value each, a field with FFM), labels and mask, its distinct rows' ids
    and counts, and each touched table row (w, z, n, cnt, V, nV) read and
    written once."""
    S = B * L
    return F * (S * (3 if fields else 2) + 2 * B + 2 * n) + 2 * F * (
        4 + 2 * K) * n


def step_flops(loss: str, B: int, L: int, n: int, K: int, F_: int) -> int:
    """The whole step's floating-point operations, counted from the
    equations of fmbench/reference.py: the forward and backward of the
    loss, the per-row sums, and the updates (FTRL about 15 a row, AdaGrad
    about 8 a factor)."""
    S = B * L
    upd = n * (15 + 8 * K)
    if loss == "ffm":
        k = K // F_
        # per ordered slot pair: x_i x_j, the k-dot of V_i[f_j] and
        # V_j[f_i] and its weighting (2k + 2), the backward's k products
        # and the field sum (3k)
        pairs = B * L * (L - 1)
        return pairs * (5 * k + 2) + S * (2 + K) + B * 10 + upd
    # per slot and factor: x V, the square, two sums, the backward
    # x (S - x V) d (4), its per-row sum
    return S * (9 * K + 4) + B * (3 * K + 10) + upd


def least_time_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The larger of the byte and the operation bound, and which it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")
