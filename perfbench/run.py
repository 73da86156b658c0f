"""Run one benchmark cell once; the last line of standard output is its
result (see ``perfbench/harness.py`` and ``perfbench/README.md``).

    python3 perfbench/run.py --workload isolet-loghd.classify --seed 7 \
        --seconds 10 --trace 0

Runs from the root of a checkout that holds ``BENCHMARK.json``,
``perfbench/`` and the program under ``src/``; exits with a code other
than 0, and prints no result, without a CUDA card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(_ROOT, "src"), _ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
