"""The benchmark's tests import its modules as ``benchmark/run.py`` does:
with ``benchmark/`` and the checkout's root on the path."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)
