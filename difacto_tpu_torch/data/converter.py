"""Offline libsvm -> binary CSR part conversion (``data_format=csr``).

Copy of ``difacto_tpu/data/converter.py``. The reference parses text on
every epoch (dmlc-core LibSVMParser); converting once to binary parts
(.npz: labels f32, indptr i64, indices u64, values f32) and streaming
those takes the parse off every epoch. The parts are the interchange
between the packages: the JAX package loads the port's parts and the
port loads the JAX package's.

    python -m difacto_tpu_torch.data.converter train.svm --out-dir parts/

writes ``parts/train.svm.part00000.npz`` ...; train on them with
``data_format=csr data_in=parts/``.

Part size matters: the loader reads one part at a time, so big parts
make the prefetch pipeline bursty; hence the 2^18-row default.
"""

from __future__ import annotations

import os

import numpy as np

from .io import open_uri
from .libsvm import RowBlock, iter_file_chunks, parse_libsvm


def _rows(blk: RowBlock, lo: int, hi: int | None = None) -> RowBlock:
    """Rows [lo, hi) of a block (to the end when ``hi`` is None)."""
    hi = blk.num_rows if hi is None else hi
    a, b = int(blk.indptr[lo]), int(blk.indptr[hi])
    return RowBlock(blk.labels[lo:hi], blk.indptr[lo:hi + 1] - blk.indptr[lo],
                    blk.indices[a:b], blk.values[a:b])


def _merge(buf: list[RowBlock]) -> RowBlock:
    ptrs, off = [np.zeros(1, np.int64)], 0
    for b in buf:
        ptrs.append(b.indptr[1:] + off)
        off += b.indptr[-1]
    return RowBlock(np.concatenate([b.labels for b in buf]),
                    np.concatenate(ptrs),
                    np.concatenate([b.indices for b in buf]),
                    np.concatenate([b.values for b in buf]))


def convert_file(
    src: str, out_prefix: str, rows_per_shard: int = 1 << 18,
    chunk_bytes: int = 64 << 20,
) -> list[str]:
    """Convert one libsvm file to one or more .npz CSR parts of
    ``rows_per_shard`` rows (the last one shorter); returns their paths."""
    outs: list[str] = []
    buf: list[RowBlock] = []
    buffered = 0

    def emit(blk: RowBlock) -> None:
        path = f"{out_prefix}.part{len(outs):05d}.npz"
        np.savez(path, labels=blk.labels, indptr=blk.indptr,
                 indices=blk.indices, values=blk.values)
        outs.append(path)

    def flush(final: bool) -> None:
        nonlocal buf, buffered
        if not buf:
            return
        blk = _merge(buf)
        lo = 0
        while blk.num_rows - lo >= rows_per_shard or (final and lo < blk.num_rows):
            hi = min(lo + rows_per_shard, blk.num_rows)
            emit(_rows(blk, lo, hi))
            lo = hi
        if lo < blk.num_rows:
            buf, buffered = [_rows(blk, lo)], blk.num_rows - lo
        else:
            buf, buffered = [], 0

    for chunk in iter_file_chunks(src, chunk_bytes):
        blk = parse_libsvm(chunk)
        buf.append(blk)
        buffered += blk.num_rows
        if buffered >= rows_per_shard:
            flush(final=False)
    flush(final=True)
    return outs


def load_csr_shard(path: str, part_index: int = 0,
                   num_parts: int = 1) -> RowBlock:
    """Load a binary CSR part, or the ``part_index``-th of ``num_parts``
    row ranges of it (rows n*i//p .. n*(i+1)//p, as the JAX package
    splits it)."""
    with open_uri(path, "rb") as f, np.load(f) as z:
        labels, indptr = z["labels"], z["indptr"]
        indices, values = z["indices"], z["values"]
    n = len(labels)
    lo = n * part_index // num_parts
    hi = n * (part_index + 1) // num_parts
    blk = RowBlock(labels.astype(np.float32, copy=False),
                   indptr.astype(np.int64, copy=False),
                   indices.astype(np.uint64, copy=False),
                   values.astype(np.float32, copy=False))
    return blk if (lo, hi) == (0, n) else _rows(blk, lo, hi)


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m difacto_tpu_torch.data.converter",
        description="convert libsvm files to binary CSR parts")
    ap.add_argument("src", nargs="+")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--rows-per-shard", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for src in args.src:
        prefix = os.path.join(args.out_dir, os.path.basename(src))
        outs = convert_file(src, prefix, args.rows_per_shard)
        print(f"{src} -> {len(outs)} shard(s)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
