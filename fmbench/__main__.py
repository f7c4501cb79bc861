"""``python -m fmbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json`` (fmbench/run.py)."""

import time

T_MAIN = time.perf_counter()

import sys  # noqa: E402

from fmbench.run import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], process_start(), T_MAIN))
