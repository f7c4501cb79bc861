"""Static-shape minibatch stream.

Copy of ``difacto_tpu/data/batch_iter.py`` (reference:
``src/data/batch_iter.h`` :: BatchIter — re-chunk a parser stream into
exact-batch_size RowBlocks, optional shuffle). Every batch has identical
static shapes (``[B, L]`` padded CSR).

Padding policy (replaces difacto's variable-length RowBlock):
  * each example is padded/truncated to ``max_nnz_per_row`` features;
  * ids are hashed into ``[0, 2**num_bits)`` here on the host
    (reference: users pre-hash; ps-lite shards raw key ranges);
  * padding slots carry id = -1 and value = 0;
  * a short final batch is padded with rows of mask = 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ..base import hash_ids
from .io import expand_uri
from .converter import load_csr_shard
from .libsvm import RowBlock, iter_file_chunks, parse_libffm, parse_libsvm

PAD_ID = -1


@dataclass
class Batch:
    """One device-ready minibatch (all arrays static-shape)."""

    ids: np.ndarray      # i32 [B, L], hashed; PAD_ID for padding slots
    vals: np.ndarray     # f32 [B, L]; 0 for padding slots
    labels: np.ndarray   # f32 [B] in {0, 1}
    mask: np.ndarray     # f32 [B]; 1 = real row, 0 = padding row
    fields: np.ndarray | None = None  # i32 [B, L] libffm field per slot
                                      # (0 on padding slots; vals==0 there)

    @property
    def batch_size(self) -> int:
        return self.ids.shape[0]

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


def rowblock_to_batches(
    blk: RowBlock,
    batch_size: int,
    max_nnz: int,
    num_bits: int,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    drop_remainder: bool = False,
) -> Iterator[Batch]:
    """Pad a CSR RowBlock into fixed [B, L] batches (with the block's
    libffm fields, when it has them, in the same slots)."""
    n = blk.num_rows
    if n == 0:
        return
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    hashed = hash_ids(blk.indices, num_bits)
    lens = np.minimum(np.diff(blk.indptr), max_nnz).astype(np.int64)
    # uniform-row fast path (Criteo-style one-hot data: every row has
    # the same nnz): the per-slot gather construction collapses to a
    # reshape + row gather, ~4x cheaper on the host
    L0 = int(lens[0]) if n else 0
    uniform = (
        L0 > 0
        and L0 <= max_nnz
        and bool((np.diff(blk.indptr) == L0).all())
        and blk.fields is None
    )
    if uniform:
        ids_all = hashed.reshape(n, L0)
        vals_all = blk.values.reshape(n, L0)
    for lo in range(0, n, batch_size):
        rows = order[lo : lo + batch_size]
        b = len(rows)
        if b < batch_size and drop_remainder:
            return
        ids = np.full((batch_size, max_nnz), PAD_ID, np.int32)
        vals = np.zeros((batch_size, max_nnz), np.float32)
        labels = np.zeros(batch_size, np.float32)
        mask = np.zeros(batch_size, np.float32)
        flds = (
            np.zeros((batch_size, max_nnz), np.int32)
            if blk.fields is not None else None
        )
        # gather positions: row r contributes indptr[r] .. indptr[r]+lens[r]
        if uniform:
            ids[:b, :L0] = ids_all[rows]
            vals[:b, :L0] = vals_all[rows]
            labels[:b] = (blk.labels[rows] > 0).astype(np.float32)
            mask[:b] = 1.0
            yield Batch(ids, vals, labels, mask)
            continue
        L = lens[rows]
        tot = int(L.sum())
        if tot:
            row_of = np.repeat(np.arange(b), L)
            within = np.arange(tot) - np.repeat(np.concatenate([[0], np.cumsum(L)[:-1]]), L)
            src = blk.indptr[rows][row_of] + within
            ids[row_of, within] = hashed[src]
            vals[row_of, within] = blk.values[src]
            if flds is not None:
                flds[row_of, within] = blk.fields[src]
        labels[:b] = (blk.labels[rows] > 0).astype(np.float32)
        mask[:b] = 1.0
        yield Batch(ids, vals, labels, mask, fields=flds)


class BatchIter:
    """Stream batches from libsvm or libffm text, or from binary CSR parts
    (``data_format`` libsvm | libffm | csr).

    Reference: BatchIter + ChunkIter + dmlc::InputSplit. ``part_index`` /
    ``num_parts`` select a disjoint byte-range shard of every file, which
    is how data parallelism splits input across hosts.
    """

    def __init__(
        self,
        uri: str | Sequence[str],
        batch_size: int,
        max_nnz: int,
        num_bits: int,
        data_format: str = "libsvm",
        part_index: int = 0,
        num_parts: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        chunk_bytes: int = 64 << 20,
        drop_remainder: bool = False,
        prefetch_blocks: int = 2,
        batch_workers: int = 2,
    ):
        self.files = expand_uri(uri) if isinstance(uri, str) else list(uri)
        self.batch_size = batch_size
        self.max_nnz = max_nnz
        self.num_bits = num_bits
        self.data_format = data_format
        self.part_index = part_index
        self.num_parts = num_parts
        self.shuffle = shuffle
        self.seed = seed
        self.chunk_bytes = chunk_bytes
        self.drop_remainder = drop_remainder
        self.prefetch_blocks = prefetch_blocks
        self.batch_workers = batch_workers
        self._epoch = 0

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        files = list(self.files)
        if self.shuffle:
            # multi-file datasets also shuffle file order per epoch
            rng.shuffle(files)
        blocks: Iterator[RowBlock] = (
            blk for path in files for blk in self._blocks(path)
        )
        if self.batch_workers > 1 and self.prefetch_blocks > 0:
            # parallel per-shard pipeline: loading/parsing runs in the
            # producer thread, id-hashing + [B, L] padding fan out to a
            # pool (each shard gets a deterministic RNG substream, so a
            # given (seed, epoch, batch_workers) replays exactly)
            from ..utils.prefetch import MappedPrefetchIter, ThreadedIter

            def batchify(blk_seed):
                blk, sub = blk_seed
                return list(rowblock_to_batches(
                    blk, self.batch_size, self.max_nnz, self.num_bits,
                    shuffle=self.shuffle,
                    rng=np.random.default_rng(sub),
                    drop_remainder=self.drop_remainder,
                ))

            seeded = ((blk, int(rng.integers(2 ** 63))) for blk in blocks)
            for lst in MappedPrefetchIter(
                ThreadedIter(seeded, depth=self.prefetch_blocks),
                batchify, workers=self.batch_workers,
            ):
                yield from lst
            return
        if self.prefetch_blocks > 0:
            # double-buffer shard reads: the next shard loads/parses in a
            # background thread while this one is padded into batches
            from ..utils.prefetch import ThreadedIter

            blocks = ThreadedIter(blocks, depth=self.prefetch_blocks)
        for blk in blocks:
            yield from rowblock_to_batches(
                blk,
                self.batch_size,
                self.max_nnz,
                self.num_bits,
                shuffle=self.shuffle,
                rng=rng,
                drop_remainder=self.drop_remainder,
            )

    @property
    def part_indices(self) -> list[int]:
        """Parts this iterator owns. ``part_index`` may be an int (one
        part) or a list (e.g. each host covering a contiguous range of
        num_parts_per_file x num_hosts total parts — the reference's
        scheduler issued every (file, part) pair as a job)."""
        if isinstance(self.part_index, (list, tuple, range)):
            return list(self.part_index)
        return [self.part_index]

    def _blocks(self, path: str) -> Iterator[RowBlock]:
        for part in self.part_indices:
            if self.data_format == "libsvm":
                for chunk in iter_file_chunks(
                    path, self.chunk_bytes, part, self.num_parts
                ):
                    yield parse_libsvm(chunk)
            elif self.data_format == "libffm":
                for chunk in iter_file_chunks(
                    path, self.chunk_bytes, part, self.num_parts
                ):
                    yield parse_libffm(chunk)
            elif self.data_format == "csr":
                yield load_csr_shard(path, part, self.num_parts)
            else:
                raise ValueError(f"unknown data_format {self.data_format!r}")
