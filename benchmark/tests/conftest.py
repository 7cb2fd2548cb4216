"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on the CPU; those marked ``cuda`` skip without a card.  The
repo root goes on ``sys.path`` so that ``benchmark`` and the port import
as they do under ``benchmark/run.py``."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
