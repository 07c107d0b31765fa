"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits non-zero, with no result, where the
cell's cards are not there.  See ``perfbench/__init__.py``."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], T0, ROOT))
