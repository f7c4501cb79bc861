"""Synthetic Criteo-like CTR data.

Copy of ``difacto_tpu/data/synthetic.py``. The reference ships no data
generator (its tests draw random sparse rows in ``tests/cpp/utils.h``);
tests and smoke runs need data that is made from a seed, without the real
Criteo sets. Rows have a fixed number of categorical fields, per-field
vocabularies with Zipf-distributed popularity, and labels drawn from a
ground-truth FM model so that learners have signal to fit (AUC well above
0.5 is reachable). With ``with_fields`` the rows carry libffm field ids,
and ``shuffle_slots`` puts them in another order than the slots.
"""

from __future__ import annotations

import numpy as np

from .libsvm import RowBlock


def make_ctr_data(
    num_rows: int,
    num_fields: int = 16,
    vocab_per_field: int = 10000,
    k_true: int = 4,
    seed: int = 0,
    zipf_a: float = 1.3,
    truth_seed: int = 12345,
    w_scale: float = 0.2,
    v_scale: float = 0.35,
    with_fields: bool = False,
    shuffle_slots: bool = False,
) -> RowBlock:
    """Generate a RowBlock of one-hot categorical rows with FM-model labels.

    ``seed`` drives row sampling; ``truth_seed`` drives the ground-truth
    model, so train/validation splits generated with different ``seed``
    share the same label distribution. ``with_fields`` attaches the libffm
    per-feature field array; ``shuffle_slots`` permutes each row's slot
    order so the field id is NOT the slot position (exercises explicit
    ``field:idx:val`` handling).
    """
    rng = np.random.default_rng(seed)
    truth_rng = np.random.default_rng(truth_seed)
    # Zipf-ish field values via floor of pareto, clipped to vocab
    raw = rng.zipf(zipf_a, size=(num_rows, num_fields))
    fv = np.minimum(raw - 1, vocab_per_field - 1)
    # globally unique raw ids: field f value v -> f * vocab + v
    ids = (np.arange(num_fields, dtype=np.uint64) * np.uint64(vocab_per_field))[None, :] + fv.astype(
        np.uint64
    )
    # ground-truth model on a hashed truth-space (independent of training hash)
    truth_bits = 18
    truth_n = 1 << truth_bits
    h = ids.astype(np.int64) % truth_n
    w_true = truth_rng.normal(0, w_scale, truth_n).astype(np.float32)
    v_true = truth_rng.normal(0, v_scale, (truth_n, k_true)).astype(np.float32)
    lin = w_true[h].sum(axis=1)
    s = v_true[h].sum(axis=1)                     # [n, k]
    q = (v_true[h] ** 2).sum(axis=(1, 2))         # sum of squares
    fm = 0.5 * ((s ** 2).sum(axis=1) - q)
    logits = lin + fm - np.median(lin + fm)
    p = 1.0 / (1.0 + np.exp(-logits))
    labels = (rng.random(num_rows) < p).astype(np.float32)
    fields = np.broadcast_to(
        np.arange(num_fields, dtype=np.int32), (num_rows, num_fields)
    )
    if shuffle_slots:
        perm = rng.random((num_rows, num_fields)).argsort(axis=1)
        ids = np.take_along_axis(ids, perm, axis=1)
        fields = np.take_along_axis(fields, perm, axis=1)
    indptr = np.arange(num_rows + 1, dtype=np.int64) * num_fields
    values = np.ones(num_rows * num_fields, np.float32)
    return RowBlock(
        labels, indptr, ids.reshape(-1), values,
        fields=fields.reshape(-1).astype(np.int32) if with_fields else None,
    )


def write_libsvm(blk: RowBlock, path: str) -> None:
    """Serialize a RowBlock to libsvm text (for end-to-end pipeline tests)."""
    with open(path, "w") as f:
        for r in range(blk.num_rows):
            lo, hi = blk.indptr[r], blk.indptr[r + 1]
            feats = " ".join(
                f"{int(blk.indices[j])}:{blk.values[j]:g}" for j in range(lo, hi)
            )
            f.write(f"{int(blk.labels[r])} {feats}\n")


def write_libffm(blk: RowBlock, path: str) -> None:
    """Serialize a RowBlock with fields to libffm text: label f:i:v ..."""
    assert blk.fields is not None, "write_libffm needs RowBlock.fields"
    with open(path, "w") as f:
        for r in range(blk.num_rows):
            lo, hi = blk.indptr[r], blk.indptr[r + 1]
            feats = " ".join(
                f"{int(blk.fields[j])}:{int(blk.indices[j])}:{blk.values[j]:g}"
                for j in range(lo, hi)
            )
            f.write(f"{int(blk.labels[r])} {feats}\n")
