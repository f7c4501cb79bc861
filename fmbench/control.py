"""The readings that set the correctness limits' upper ends, at a cell's own
size, on the card (the benchmark's own runs do not run this):

    python3 -m fmbench.control --workload <cell> --seeds 11 12 13

For each seed it makes the cell's rows as a run does, trains the first
steps with the model's plain reference (its module's ``reference``) in
float64, and compares with it, by the numbers of fmbench/check.py:

* ``control``: the reference in the program's place, computed in bfloat16,
  the nearest precision below the float32 the configurations state (the
  step has no matrix product, so TF32 has nothing to act on);
* ``half_batch``: the reference with the second half of each batch left
  out and the mean taken over the rest;
* ``frozen``: the reference with every step leaving the table unchanged.

One JSON line a seed and reading. The sound runs' readings, the lower
ends, are what the benchmark's own runs print.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import check, run, traffic

READINGS = {"control": dict(dtype=torch.bfloat16),
            "half_batch": dict(fault="half_batch"),
            "frozen": dict(fault="frozen")}


def readings(root: Path, workload: str, seed: int, device) -> dict:
    """{reading: fmbench/check.py's numbers} for one seed."""
    cell = run.load_cell(root, workload)
    mod = run.load_model(root, cell.config)
    m = mod.Model.of(cell.config["conf"])
    first = run.first_batches(traffic.make_rows(cell.traffic, seed, device))
    ref = mod.reference(seed, first, m, device)
    return {name: check.compare(mod.reference(seed, first, m, device, **kw),
                                ref, mod.LEAVES)
            for name, kw in READINGS.items()}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m fmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fmbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in a.seeds:
        t = time.perf_counter()
        got = readings(Path.cwd(), a.workload, seed, dev)
        for name, numbers in got.items():
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "reading": name, **numbers,
                              "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
