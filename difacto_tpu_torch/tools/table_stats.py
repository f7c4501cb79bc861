"""Table load/skew statistics from a checkpoint.

SURVEY.md §7 lists Criteo's power-law key distribution as a design risk:
hot keys imbalance the sharded all_to_all and concentrate updates. This
tool reports the observables needed to diagnose that from a trained
model's count table:

    python -m difacto_tpu_torch.tools.table_stats ckpt/fm [--shards S]

Prints: occupancy (touched rows), count quantiles, top-k hottest rows,
the share of traffic carried by the hottest 0.1%/1% of rows, and — with
``--shards`` — the per-shard load balance the contiguous-range
partitioning would produce (reference: ps-lite GetServerKeyRanges).

Port of ``difacto_tpu/tools/table_stats.py``: host NumPy over the port's
``utils/checkpoint.load_full``, local or remote prefix (data/io.py), of a
one-file checkpoint or a multi-process run's per-process file set; the
same dict on the same checkpoint.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import checkpoint


def stats(prefix: str, shards: int = 0, topk: int = 10) -> dict:
    state, _ = checkpoint.load_full(prefix)
    cnt = np.asarray(state.cnt, dtype=np.float64)
    n = len(cnt)
    touched = cnt > 0
    total = cnt.sum()
    out = {
        "rows": n,
        "touched": int(touched.sum()),
        "occupancy": float(touched.mean()),
        "total_count": float(total),
    }
    if touched.any() and total > 0:
        tc = cnt[touched]
        qs = np.quantile(tc, [0.5, 0.9, 0.99, 0.999])
        out["count_quantiles"] = {
            "p50": qs[0], "p90": qs[1], "p99": qs[2], "p99.9": qs[3],
            "max": float(tc.max()),
        }
        order = np.argsort(cnt)[::-1]
        out["top_rows"] = [
            {"row": int(r), "count": float(cnt[r])} for r in order[:topk]
        ]
        csum = np.cumsum(cnt[order])
        for frac in (0.001, 0.01, 0.1):
            k = max(int(n * frac), 1)
            out[f"traffic_share_top_{frac:g}"] = float(csum[k - 1] / total)
    if shards > 1:
        if n % shards:
            out["shard_load"] = f"unavailable: {shards} does not divide {n} rows"
        else:
            per = cnt.reshape(shards, -1).sum(axis=1)
            out["shard_load"] = {
                "mean": float(per.mean()),
                "max_over_mean": float(per.max() / max(per.mean(), 1e-12)),
                "min_over_mean": float(per.min() / max(per.mean(), 1e-12)),
            }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("prefix")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--topk", type=int, default=10)
    args = ap.parse_args(argv)
    import json

    print(json.dumps(stats(args.prefix, args.shards, args.topk), indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
