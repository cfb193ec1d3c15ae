#!/usr/bin/env python3
"""Standalone entry point for the port's chaos drill — usable without
PYTHONPATH:

    python tools/chaos_drill_torch.py [--device cpu] [--out out/CHAOS_drill.json]

Equivalent to ``PYTHONPATH=src python -m repro_torch.launch.chaos_drill``:
the replay-service gang through a hard server kill and a snapshot restore,
its contracts checked, its report written to ``--out``; exit 1 on any
broken contract.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.chaos_drill import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
