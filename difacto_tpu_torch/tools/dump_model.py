"""Dump a model checkpoint to inspectable text.

The reference stores models as opaque binary streams of
(feaid, cnt, w, z, sqrt_g, V[]) records (``SGDUpdater::Save``); users
inspect them with ad-hoc readers. Here the equivalent is one command:

    python -m difacto_tpu_torch.tools.dump_model ckpt/fm [-o model.txt]
        [--limit N] [--all]

Each output line: ``row_index count w [V_0 ... V_k-1]`` for rows with
nonzero w or an activated factor (``--all`` dumps every row). Row index
is the hashed table row (the reference dumps raw feature ids; hashing is
many-to-one, so the hash row is the model's native key here).

Port of ``difacto_tpu/tools/dump_model.py``: host NumPy over the port's
``utils/checkpoint.load``, local or remote prefix (data/io.py); the same
text, byte for byte, on the same checkpoint. The per-process sharded
layout (``load_full`` in the JAX package) waits for ROADMAP A9b and raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import checkpoint


def dump(prefix: str, out, limit: int = 0, include_all: bool = False) -> int:
    state, meta = checkpoint.load(prefix)
    w = np.asarray(state.w)
    v = np.asarray(state.V)  # planar [K, N]
    cnt = np.asarray(state.cnt)
    k = v.shape[0]
    if include_all:
        rows = np.arange(len(w))
    else:
        keep = w != 0
        if k:
            keep |= (v != 0).any(axis=0) & (cnt > 0)
        rows = np.nonzero(keep)[0]
    if limit:
        rows = rows[:limit]
    for r in rows:
        fields = [str(int(r)), "%g" % cnt[r], "%.6g" % w[r]]
        if k:
            fields += ["%.6g" % x for x in v[:, r]]
        out.write(" ".join(fields) + "\n")
    return len(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("prefix", help="checkpoint path prefix (no .npz)")
    ap.add_argument("-o", "--out", default="-", help="output file (default stdout)")
    ap.add_argument("--limit", type=int, default=0, help="max rows (0 = all)")
    ap.add_argument("--all", action="store_true", help="include zero rows")
    args = ap.parse_args(argv)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        n = dump(args.prefix, out, args.limit, args.all)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"dumped {n} rows", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
