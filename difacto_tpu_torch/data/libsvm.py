"""libsvm text parsing into CSR arrays.

Copy of ``difacto_tpu/data/libsvm.py`` (reference: dmlc-core
``libsvm_parser.h`` :: LibSVMParser and ``dmlc/data.h`` :: RowBlock).
Output is a plain CSR quadruple (labels, indptr, indices (uint64 raw
ids), values), with a field per feature for libffm, which the batch
iterator hashes and pads into static shapes.

Two libsvm engines, as in the JAX package: the multithreaded C++ parser
(data/_native.py, built on first use) and a vectorized NumPy engine, which
gives the same arrays and runs where the native one cannot be built.
libffm has the NumPy engine alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class RowBlock:
    """Host CSR block (reference: dmlc::RowBlock<feaid_t>; the optional
    ``fields`` array mirrors dmlc's RowBlock::field for libffm data)."""

    labels: np.ndarray   # f32 [n]  (raw labels as in file; 0/1 or -1/+1)
    indptr: np.ndarray   # i64 [n+1]
    indices: np.ndarray  # u64 [nnz] raw feature ids
    values: np.ndarray   # f32 [nnz]
    fields: np.ndarray | None = None  # i32 [nnz] libffm field per feature

    @property
    def num_rows(self) -> int:
        return len(self.labels)

    @property
    def nnz(self) -> int:
        return len(self.indices)


def _tokenize(data: bytes):
    """Shared vectorized tokenizer: returns (n_lines, label_tokens,
    feat_tokens, feat_line_of) or None for empty input."""
    lines = [ln for ln in data.splitlines() if ln.strip() and not ln.lstrip().startswith(b"#")]
    if not lines:
        return None
    buf = b"\n".join(lines) + b"\n"
    arr = np.frombuffer(buf, np.uint8)
    # token starts: non-whitespace byte preceded by whitespace / buf start
    # (whitespace set matches bytes.split(): space, tab, \n, \r, \v, \f)
    ws = (
        (arr == 0x20) | (arr == 0x09) | (arr == 0x0A)
        | (arr == 0x0D) | (arr == 0x0B) | (arr == 0x0C)
    )
    starts = np.flatnonzero(~ws & np.concatenate([[True], ws[:-1]]))
    nl = np.flatnonzero(arr == 0x0A)
    line_of = np.searchsorted(nl, starts, side="right")
    tokens = np.array(buf.split())
    assert tokens.size == starts.size
    is_label = np.concatenate([[True], line_of[1:] != line_of[:-1]])
    if int(is_label.sum()) != len(lines):
        raise ValueError("malformed libsvm input (line without tokens)")
    return len(lines), tokens[is_label], tokens[~is_label], line_of[~is_label]


def _empty_block() -> RowBlock:
    return RowBlock(
        np.zeros(0, np.float32),
        np.zeros(1, np.int64),
        np.zeros(0, np.uint64),
        np.zeros(0, np.float32),
    )


def parse_libsvm_numpy(data: bytes) -> RowBlock:
    """Vectorized libsvm parse of one chunk. Supports 'label i:v i:v ...' lines; ignores
    blank lines and '#' comments. Bare indices ('i' without ':v') mean
    value 1.0, matching the dmlc parser and the C++ engine (dmlc-core
    ``libsvm_parser.h`` semantics)."""
    tok = _tokenize(data)
    if tok is None:
        return _empty_block()
    n_lines, label_tok, feat, line_of = tok
    try:
        labels = label_tok.astype(np.float32)
        if feat.size == 0:
            # all rows feature-less (legal: bias-only examples)
            indices = np.zeros(0, np.uint64)
            values = np.zeros(0, np.float32)
        else:
            # 'i:v' -> (i, ':', v); bare 'i' -> (i, '', '') => value 1.0
            part = np.char.partition(feat, b":")
            indices = part[:, 0].astype(np.uint64)
            values = np.where(part[:, 1] == b":", part[:, 2], b"1").astype(np.float32)
    except ValueError as e:
        raise ValueError(f"malformed libsvm input: {e}") from None
    nnz = np.bincount(line_of, minlength=n_lines).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    return RowBlock(labels, indptr, indices, values)


def parse_libffm(data: bytes) -> RowBlock:
    """Vectorized libffm parse: 'label f:i:v f:i:v ...' lines (the libffm
    tool's format; dmlc-core reads it as RowBlock::field). 'f:i' without
    the value means value 1.0. Returns a RowBlock with ``fields`` set."""
    tok = _tokenize(data)
    if tok is None:
        blk = _empty_block()
        blk.fields = np.zeros(0, np.int32)
        return blk
    n_lines, label_tok, feat, line_of = tok
    try:
        labels = label_tok.astype(np.float32)
        if feat.size == 0:
            fields = np.zeros(0, np.int64)
            indices = np.zeros(0, np.uint64)
            values = np.zeros(0, np.float32)
        else:
            p1 = np.char.partition(feat, b":")        # f | ':' | 'i:v'
            if not bool((p1[:, 1] == b":").all()):
                raise ValueError("feature token without ':' (need field:idx[:val])")
            fields = p1[:, 0].astype(np.int64)
            p2 = np.char.partition(p1[:, 2], b":")    # i | ':' | v
            indices = p2[:, 0].astype(np.uint64)
            values = np.where(p2[:, 1] == b":", p2[:, 2], b"1").astype(np.float32)
    except ValueError as e:
        raise ValueError(f"malformed libffm input: {e}") from None
    if len(fields) and (fields.min() < 0):
        raise ValueError("malformed libffm input: negative field id")
    nnz = np.bincount(line_of, minlength=n_lines).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    return RowBlock(labels, indptr, indices, values, fields.astype(np.int32))


def parse_libsvm(data: bytes) -> RowBlock:
    """Parse one chunk with the native engine where it is built (on the
    first call), else with the NumPy engine; data/_native.py counts
    which one ran."""
    from . import _native

    if _native.available():
        _native.count("parse_native")
        return _native.parse_libsvm(data)
    _native.count("parse_numpy")
    return parse_libsvm_numpy(data)


def iter_file_chunks(
    path: str, chunk_bytes: int = 64 << 20, part_index: int = 0, num_parts: int = 1
) -> Iterator[bytes]:
    """Stream a text file in line-aligned chunks, optionally reading only
    the part_index-th of num_parts byte ranges (record-aligned at newline
    boundaries). Counterpart of dmlc ``InputSplit`` + ``ChunkIter``:
    this is how each worker/job reads a disjoint shard of a file.

    ``.gz`` files are supported as compressed streams (dmlc-core reads
    gzip via its stream layer too). Gzip is not byte-range seekable, so
    parts of a .gz file are line-aligned decompressed chunks dealt
    round-robin by chunk index — every part decompresses the stream but
    parses only its share; with many files, prefer one part per file.
"""
    from .io import open_uri, uri_size

    if path.endswith(".gz"):
        yield from _iter_gzip_chunks(path, chunk_bytes, part_index, num_parts)
        return
    size = uri_size(path)
    lo = size * part_index // num_parts
    hi = size * (part_index + 1) // num_parts
    with open_uri(path, "rb") as f:
        # advance lo to the next line start (unless at file start)
        if lo > 0:
            f.seek(lo - 1)
            f.readline()
            lo = f.tell()
        pos = lo
        carry = b""
        while pos < hi:
            n = min(chunk_bytes, hi - pos)
            block = f.read(n)
            pos += len(block)
            if pos >= hi and not block.endswith(b"\n"):
                # finish the final line only if it actually crosses hi —
                # a part boundary landing exactly on a newline belongs to
                # the NEXT part (whose lo-adjustment starts right there)
                block += f.readline()
                pos = f.tell()
            cut = block.rfind(b"\n")
            if cut < 0:
                carry += block
                continue
            yield carry + block[: cut + 1]
            carry = block[cut + 1 :]
        if carry.strip():
            yield carry


def _iter_gzip_chunks(
    path: str, chunk_bytes: int, part_index: int, num_parts: int
) -> Iterator[bytes]:
    """Line-aligned chunks of a gzip stream, round-robin across parts."""
    import gzip

    from .io import open_uri

    idx = 0
    carry = b""
    with open_uri(path, "rb") as raw, gzip.GzipFile(fileobj=raw) as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            cut = block.rfind(b"\n")
            if cut < 0:
                carry += block
                continue
            chunk = carry + block[: cut + 1]
            carry = block[cut + 1 :]
            if idx % num_parts == part_index:
                yield chunk
            idx += 1
    if carry.strip() and idx % num_parts == part_index:
        yield carry
