"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the repository root. Tests that need the card are marked `cuda` and skip
without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0 if p == str(BENCH) else 1, p)
