#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on this host's cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints each number compared with its limit as the last lines of standard
error and one JSON object as the last line of standard output. Exits 2,
with no result, when this host has no CUDA or fewer cards than the cell
asks for, and 3 when JAX or the JAX package was loaded. See
``portbench/harness.py``.
"""

import time

T0 = time.time()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
