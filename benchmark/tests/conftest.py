"""The benchmark's CPU tests: ``python -m pytest benchmark/tests`` from the
repository's root.  Tests marked ``cuda`` skip without a card."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
