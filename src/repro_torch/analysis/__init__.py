"""repro-lint for the port: static analysis of ``src/repro_torch``, the
counterpart of ``repro.analysis`` (the reference's repro-lint).

Four stdlib-``ast`` passes, under the reference's rule ids where the
hazard carries over:

  * in-place safety (D1xx, ``donation.py``) — the port updates in place
    the buffers that the reference donates;
  * collective uniformity (C2xx, ``collectives.py``) — every rank runs the
    whole program eagerly over ``torch.distributed``;
  * lock discipline (L3xx, ``locks.py``) — a copy of the reference's;
  * host syncs (R401, R404, ``retrace.py``) — the registered step programs
    read nothing back from the device.

``python -m repro_torch.analysis`` (or ``tools/repro_lint_torch.py``)
runs them with the reference's flags and exit codes; the baseline is
``src/repro_torch/analysis/baseline.json``.  Nothing in this package may
import torch, numpy, or anything beyond the standard library and
``repro_torch.analysis``: the lint runs without the ML dependencies.
"""

from repro_torch.analysis import collectives, donation, locks, retrace
from repro_torch.analysis.common import RULES, Finding, SourceFile

# the pass registry the CLI runs, in report order
PASSES = (donation.run, collectives.run, locks.run, retrace.run)

__all__ = ["PASSES", "RULES", "Finding", "SourceFile"]
