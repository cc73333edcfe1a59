"""The benchmark of the PyTorch and CUDA port (``pylbl_tpu_torch``): one run
of one cell of ``BENCHMARK.json``.

    python3 lblbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout; it exits 3 without the CUDA cards the cell
asks for.  See ``lblbench/harness/main.py``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lblbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
