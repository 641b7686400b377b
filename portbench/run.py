#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout. The harness puts ``src`` on the path, keeps
its build caches under ``build/`` in the checkout, and exits non-zero
without printing a result when the machine has no CUDA card (or fewer
than the cell asks for). See ``portbench/harness.py``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
