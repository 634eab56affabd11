"""The benchmark's command: ``python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``, run from the root of a checkout.
Prints one JSON line last; see ``benchmark/harness.py``."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
