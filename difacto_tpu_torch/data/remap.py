"""Frequency-ordered row remap: the hottest rows in a small hot table.

Copy of ``difacto_tpu/data/remap.py`` (the port imports nothing of the
JAX package), with its constant, so that both packages choose the same
hot-table size. The JAX package built the split for a TPU scatter cliff:
an XLA scatter-add there cost ~7x more an index into a table past ~2^18
rows at K = 16. Whether the split helps on this card is measured, not
assumed (PERF.md).

The remap is a per-run LAYOUT: a bijection over hash-table rows that
puts the ``hot_rows`` most frequent rows of a count sample at
[0, hot_rows), applied on the host in prep before the dedup, so the
sorted uniques, the inverse and the sorted slots all live in remapped
space. Checkpoints stay in canonical hash-row space
(utils/checkpoint.py), so the mapping never leaves the run.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)

# hot-table byte budget of the JAX package: [pad8(4+2K), H] f32 within
# 48 MB (2^18 rows at K = 16 is 42 MB)
_HOT_BYTES_CAP = 48 << 20


def auto_hot_rows(num_rows: int, v_dim: int) -> int:
    """Largest power-of-two hot-head size inside the byte budget (and at
    most num_rows / 4)."""
    d_pad = (4 + 2 * v_dim + 7) // 8 * 8
    h = 1
    while (h * 2) * d_pad * 4 <= _HOT_BYTES_CAP and h * 2 <= num_rows // 4:
        h *= 2
    return h


def build_remap(cnt: np.ndarray, hot_rows: int) -> np.ndarray:
    """Bijective row relabeling from observed row frequencies: ``lut[r]``
    is row r's new label; the ``hot_rows`` most frequent rows get
    [0, hot_rows), every other row [hot_rows, N). An O(N)
    argpartition, no full sort of the count array."""
    n = cnt.shape[0]
    assert 0 < hot_rows < n
    order = np.argpartition(cnt, n - hot_rows)  # last hot_rows = hottest
    lut = np.empty(n, np.int32)
    lut[order[n - hot_rows:]] = np.arange(hot_rows, dtype=np.int32)
    lut[order[: n - hot_rows]] = np.arange(hot_rows, n, dtype=np.int32)
    return lut


def invert_remap(lut: np.ndarray) -> np.ndarray:
    """inv[new_label] = original row."""
    inv = np.empty_like(lut)
    inv[lut] = np.arange(lut.shape[0], dtype=lut.dtype)
    return inv


def apply_remap(ids: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Relabel a padded [B, L] id matrix (PAD_ID -1 passes through)."""
    out = lut[np.maximum(ids, 0)]
    return np.where(ids < 0, ids, out)


def count_sample(batch_iter, num_rows: int, max_batches: int) -> np.ndarray:
    """Row-frequency counts (i32 [num_rows]) from the first
    ``max_batches`` batches of an iterator of Batch objects (hashed ids,
    -1 pads), in one bincount over the whole sample."""
    chunks = []
    n = 0
    for b in batch_iter:
        flat = np.asarray(b.ids).reshape(-1)
        chunks.append(flat[flat >= 0])
        n += 1
        if n >= max_batches:
            break
    log.info("hot-remap count sample: %d batches", n)
    if not chunks:
        return np.zeros(num_rows, np.int32)
    return np.bincount(np.concatenate(chunks),
                       minlength=num_rows).astype(np.int32)
