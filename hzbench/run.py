"""Run one cell of the benchmark once and print its result.

    python3 hzbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (JSON); the numbers
compared with the reference, each beside its limit, are the last lines of
standard error.  Exits nonzero, with no result, without the CUDA devices
the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from hzbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
