"""The benchmark's tests: `python -m pytest perfbench/tests` from the root of
a checkout. The root goes on sys.path, so that `perfbench` and the program
import as they do under run.py."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
