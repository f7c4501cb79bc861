"""Core typedefs and constants.

Copy of ``difacto_tpu/base.py`` (the port imports nothing of the JAX
package): feature ids remain raw 64-bit integers at the data layer and
are hashed into a bounded power-of-two id space before reaching the
device, where the table is a dense array indexed by hashed id.
"""

from __future__ import annotations

import numpy as np

# kwargs lists parsed from config files (reference: KWArgs).
KWArgs = list[tuple[str, str]]


_malloc_tuned = False


def tune_malloc() -> None:
    """Raise glibc's mmap/trim thresholds so large NumPy temporaries are
    served from the reused heap instead of fresh mmaps.

    The default malloc behavior (mmap for >128 KB, trim freed heap back
    to the OS) makes every large ingest temporary pay fresh page faults,
    which are costly on virtualized hosts. The env-var equivalents
    (MALLOC_MMAP_THRESHOLD_/MALLOC_TRIM_THRESHOLD_) are read at process
    start; ``mallopt`` applies the same tuning at runtime. No-op on
    non-glibc platforms. Call early (CLI/bench entry)."""
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:  # pragma: no cover - non-glibc
        pass


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Mix raw 64-bit feature ids into uniformly distributed 64-bit hashes.

    The reference shards raw keys by uniform ranges of the uint64 space
    (ps-lite ``GetServerKeyRanges``); real-world ids are *not* uniform, so
    users pre-hash. We make hashing a first-class, deterministic step:
    splitmix64 finalizer, then the caller takes ``hash & (table_size - 1)``.

    In-place ops over two buffers (the working copy and one shift temp):
    at 10M ids the naive expression tree allocates ~6 fresh 80 MB arrays,
    which is pure page-fault cost on virtualized hosts (see tune_malloc).
    """
    z = np.array(x, dtype=np.uint64)  # working copy
    t = np.empty_like(z)
    with np.errstate(over="ignore"):
        z += np.uint64(0x9E3779B97F4A7C15)
        np.right_shift(z, np.uint64(30), out=t)
        z ^= t
        z *= np.uint64(0xBF58476D1CE4E5B9)
        np.right_shift(z, np.uint64(27), out=t)
        z ^= t
        z *= np.uint64(0x94D049BB133111EB)
        np.right_shift(z, np.uint64(31), out=t)
        z ^= t
    return z


def hash_ids(ids: np.ndarray, num_bits: int) -> np.ndarray:
    """Hash raw feature ids into ``[0, 2**num_bits)`` (int32/int64).

    This is the table-sharding function: with a row-sharded table over S
    shards, the owner of a hashed id ``h`` is ``h // (table_size // S)``
    (contiguous ranges, so sorted unique ids bucket into contiguous runs).
    """
    assert 1 <= num_bits <= 30, "table indices + sentinel must fit int32"
    h = splitmix64(ids) & np.uint64((1 << num_bits) - 1)
    return h.astype(np.int32)
