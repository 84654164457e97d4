"""Run one cell of the benchmark of repro_torch on the cards of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
run's result as one JSON object; the compared numbers and their limits are
the last lines of standard error. See perfbench/README.md.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:]))
