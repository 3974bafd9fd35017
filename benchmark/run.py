"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json at the root of the checkout; lib/spec.py says where the
files for each name live.  Exits with code 2, printing no result, when
JAX finds no GPU or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
