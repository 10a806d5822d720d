"""The benchmark's entry point: one run of one cell (see bench/bcbench/harness.py).

    python3 bench/run.py --workload bc-rmat-s17.exact --seed 7 --seconds 10 --trace 0
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bcbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
