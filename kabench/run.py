"""Run one cell of the benchmark once, on the card::

    python3 kabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks on standard error and one JSON result line last on
standard output. Exits non-zero, printing no result, without the CUDA
devices the cell asks for: there is no CPU fallback.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kabench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
