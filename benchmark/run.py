"""Run one cell of the port's benchmark once, on the card this machine holds.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON result line as the last line
of standard output; the numbers ``correct`` was decided on, each beside
its limit, are the last lines of standard error.  Exits non-zero, with no
result, where there is no card, where the cell needs more cards than there
are, or where the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root in place of this script's folder, whose modules
    # (``trace``, ...) would otherwise shadow standard ones
    sys.path[0] = str(ROOT)

from benchmark.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(ROOT, sys.argv[1:], T0))
