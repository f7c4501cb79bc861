"""Disk-backed column-block tile cache for BCD.

Copy of ``difacto_tpu/data/tile_store.py`` (reference:
``src/data/tile_store.h`` :: TileStore + ``src/data/tile_builder.h`` ::
TileBuilder), NumPy and memmaps as there: the training data, transposed
into per-feature-block tiles, cached OUTSIDE RAM so coordinate descent
over datasets larger than memory never re-reads/re-parses the raw text.
It writes the same files (``row.i32``, ``col.i32``, ``val.f32``,
``offsets.npy``, ``extents.npy``, ``labels.npy``, ``tiles.json``) with the
same dtypes and keys, so a tile directory built by either package loads
in the other.

Build is two streaming passes over the input (RAM stays O(batch)):

  pass 1: count examples and per-(block, row-shard) nnz; collect labels
          (4 bytes/example — the only O(n) host residue);
  pass 2: write (local_row, local_col, value) COO triplets into exact
          per-(block, shard) regions of on-disk memmaps via running
          cursors.

Rows are assigned to the ``num_shards`` row shards ROUND-ROBIN
(shard = row % S, local index = row // S) so pass 1 needs no row total,
and each shard's example set is balanced. The shard-major example
order (position s*rows_per_shard + row//S) is the layout of the py /
label vectors during training; :meth:`to_shard_order` maps into it.
Within a (block, shard) tile the triplets keep stream order, so the local
row never decreases along a tile.

``fetch(block)`` returns [S, T] arrays (T = max per-(block,shard) nnz,
the JAX package's one static shape; ``block_nnz(block)`` is the T of one
block, which is all a PyTorch step needs); padding slots carry row 0,
column 0 and value 0, so they contribute nothing to the scatter-adds.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

log = logging.getLogger("difacto_tpu_torch")


class TileStore:
    def __init__(self, tile_dir: str):
        self.dir = tile_dir
        with open(os.path.join(tile_dir, "tiles.json")) as f:
            m = json.load(f)
        self.num_blocks = m["num_blocks"]
        self.num_shards = m["num_shards"]
        self.rows_per_block = m["rows_per_block"]
        self.tile_nnz = m["tile_nnz"]  # T: max per-(block,shard) extent
        self.n = m["n"]                # real example count
        self.n_pad = m["n_pad"]
        self.total_nnz = m["total_nnz"]
        self._offsets = np.load(os.path.join(tile_dir, "offsets.npy"))
        self._extents = np.load(os.path.join(tile_dir, "extents.npy"))
        mode = "r"
        self._row = np.memmap(
            os.path.join(tile_dir, "row.i32"), np.int32, mode, shape=(self.total_nnz,)
        )
        self._col = np.memmap(
            os.path.join(tile_dir, "col.i32"), np.int32, mode, shape=(self.total_nnz,)
        )
        self._val = np.memmap(
            os.path.join(tile_dir, "val.f32"), np.float32, mode, shape=(self.total_nnz,)
        )
        self.labels = np.load(os.path.join(tile_dir, "labels.npy"))

    @property
    def rows_per_shard(self) -> int:
        return self.n_pad // self.num_shards

    def to_shard_order(
        self, per_row: np.ndarray, fill=0.0, rows_per_shard: int | None = None
    ) -> np.ndarray:
        """Map a [n] per-example vector into the shard-major layout
        (device s's rows contiguous). ``rows_per_shard`` may exceed the
        local minimum (multi-host: every process pads its shards to the
        globally agreed length)."""
        rps = rows_per_shard or self.rows_per_shard
        out = np.full(self.num_shards * rps, fill, np.asarray(per_row).dtype)
        g = np.arange(self.n)
        out[(g % self.num_shards) * rps + g // self.num_shards] = per_row
        return out

    def from_shard_order(
        self, sharded: np.ndarray, rows_per_shard: int | None = None
    ) -> np.ndarray:
        """Inverse of :meth:`to_shard_order` (drops padding)."""
        rps = rows_per_shard or self.rows_per_shard
        g = np.arange(self.n)
        return np.asarray(sharded)[
            (g % self.num_shards) * rps + g // self.num_shards
        ]

    def block_nnz(self, block: int) -> int:
        """The largest shard extent of one block: the T that holds it."""
        return max(int(self._extents[block].max()), 1)

    def fetch(self, block: int, tile_nnz: int | None = None):
        """[S, T] (local_row, local_col, value) for one feature block.
        ``tile_nnz`` pads T beyond the local maximum (multi-host: all
        processes must place identically shaped tile arrays)."""
        S, T = self.num_shards, tile_nnz or self.tile_nnz
        tr = np.zeros((S, T), np.int32)
        tc = np.zeros((S, T), np.int32)
        tv = np.zeros((S, T), np.float32)
        for s in range(S):
            o = self._offsets[block, s]
            e = self._extents[block, s]
            tr[s, :e] = self._row[o : o + e]
            tc[s, :e] = self._col[o : o + e]
            tv[s, :e] = self._val[o : o + e]
        return tr, tc, tv


def build_tiles(
    batch_iter_factory,
    tile_dir: str,
    num_rows: int,
    num_blocks: int,
    num_shards: int,
) -> TileStore:
    """Two-pass streaming TileBuilder (see module docstring).

    ``batch_iter_factory`` is a zero-arg callable returning a fresh batch
    stream (each pass consumes one full stream)."""
    os.makedirs(tile_dir, exist_ok=True)
    rows_per_block = num_rows // num_blocks
    NB, S = num_blocks, num_shards

    # pass 1: labels + per-(block, shard) nnz counts
    counts = np.zeros(NB * S, np.int64)
    labels = []
    n = 0
    for batch in batch_iter_factory():
        b = int(batch.mask.sum())
        ids = batch.ids[:b]
        r, l = np.nonzero(ids >= 0)
        col = ids[r, l].astype(np.int64)
        key = (col // rows_per_block) * S + ((r + n) % S)
        np.add.at(counts, key, 1)
        labels.append(batch.labels[:b])
        n += b
    labels = (
        np.concatenate(labels) if labels else np.zeros(0, np.float32)
    ).astype(np.float32)
    total = int(counts.sum())
    n_pad = max((n + S - 1) // S * S, S)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)

    # pass 2: write triplets into exact regions
    mm_row = np.memmap(os.path.join(tile_dir, "row.i32"), np.int32, "w+", shape=(max(total, 1),))
    mm_col = np.memmap(os.path.join(tile_dir, "col.i32"), np.int32, "w+", shape=(max(total, 1),))
    mm_val = np.memmap(os.path.join(tile_dir, "val.f32"), np.float32, "w+", shape=(max(total, 1),))
    cursor = offsets.copy()
    n2 = 0
    for batch in batch_iter_factory():
        b = int(batch.mask.sum())
        ids = batch.ids[:b]
        r, l = np.nonzero(ids >= 0)
        col = ids[r, l].astype(np.int64)
        grow = (r + n2).astype(np.int64)
        key = (col // rows_per_block) * S + (grow % S)
        order = np.argsort(key, kind="stable")
        sk = key[order]
        uk, start, cnt = np.unique(sk, return_index=True, return_counts=True)
        within = np.arange(len(sk)) - np.repeat(start, cnt)
        dest = cursor[sk] + within
        mm_row[dest] = (grow[order] // S).astype(np.int32)   # local row
        mm_col[dest] = (col[order] % rows_per_block).astype(np.int32)
        mm_val[dest] = batch.vals[:b][r, l][order]
        cursor[uk] += cnt
        n2 += b
    assert n2 == n and (cursor == offsets + counts).all()
    mm_row.flush(); mm_col.flush(); mm_val.flush()

    np.save(os.path.join(tile_dir, "offsets.npy"), offsets.reshape(NB, S))
    np.save(os.path.join(tile_dir, "extents.npy"), counts.reshape(NB, S))
    np.save(os.path.join(tile_dir, "labels.npy"), labels)
    meta = {
        "num_blocks": NB,
        "num_shards": S,
        "rows_per_block": rows_per_block,
        "tile_nnz": int(counts.max()) if total else 1,
        "n": n,
        "n_pad": n_pad,
        "total_nnz": max(total, 1),
    }
    with open(os.path.join(tile_dir, "tiles.json"), "w") as f:
        json.dump(meta, f)
    log.info(
        "tile store built: %d rows, %d nnz, %d blocks x %d shards "
        "(tile nnz %d) at %s", n, total, NB, S, meta["tile_nnz"], tile_dir,
    )
    return TileStore(tile_dir)
