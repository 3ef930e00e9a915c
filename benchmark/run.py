"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA device(s) the cell
asks for (BENCHMARK.json).  The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and with --trace 1
breakdown), then the numbers compared with their limits; the same numbers
are the last lines of standard error.  Without the devices it prints no
result and exits 2.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, heads the path: no module here
# shadows one of the standard library's
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.lib import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
