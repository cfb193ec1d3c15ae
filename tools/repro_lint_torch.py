#!/usr/bin/env python3
"""Standalone entry point for the port's repro-lint — usable without
PYTHONPATH:

    python tools/repro_lint_torch.py [--check] [paths…]

Equivalent to ``PYTHONPATH=src python -m repro_torch.analysis``: the
four passes over ``src/repro_torch`` against the port's own baseline,
``src/repro_torch/analysis/baseline.json`` (``--list-rules`` prints the
rule table).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
