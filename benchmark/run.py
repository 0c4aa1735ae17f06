"""Run one benchmark cell: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout.
The last line of standard output is the result as JSON; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
