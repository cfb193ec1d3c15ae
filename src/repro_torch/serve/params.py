"""Double-buffered parameter publication for the serve path — port of
``repro.serve.params`` (DESIGN.md §13), ``ParamDoubleBuffer`` only.

The learner updates fresh params on its own clock, the actor acts on a
stable copy, and the handoff happens at the ``serve_step`` boundary:
``stage`` may be called from any thread at any time (it only touches the
*staged* half), and the serve loop calls ``swap_if_staged`` exactly once
per step, so one batch step never mixes two parameter versions.  The
swap is a reference flip, not a copy.

``ServiceParamChannel`` (the replay service's params channel as the
publisher) waits for the port of ``service/``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

Pytree = Any


class ParamDoubleBuffer:
    """live/staged versioned parameter pair with boundary-only swaps."""

    def __init__(self, params: Pytree, version: int = 0):
        self._lock = threading.Lock()
        self._live = params
        self._live_version = int(version)
        self._staged: Optional[Tuple[int, Pytree]] = None
        self._swaps = 0

    def stage(self, params: Pytree, version: Optional[int] = None) -> int:
        """Publish a new tree (any thread).  Does NOT touch the live
        half — the serve loop picks it up at its next step boundary.
        Monotonic versions only; a stale publish is dropped."""
        with self._lock:
            if version is None:
                staged_v = self._staged[0] if self._staged else self._live_version
                version = staged_v + 1
            version = int(version)
            if version <= self._live_version or (
                    self._staged is not None and version <= self._staged[0]):
                return self._live_version  # stale publish — keep what we have
            self._staged = (version, params)
            return version

    def swap_if_staged(self) -> Tuple[Pytree, int, bool]:
        """Serve-loop boundary: promote the staged tree if any.  Returns
        ``(live params, live version, swapped)``."""
        with self._lock:
            if self._staged is not None:
                self._live_version, self._live = self._staged
                self._staged = None
                self._swaps += 1
                return self._live, self._live_version, True
            return self._live, self._live_version, False

    @property
    def version(self) -> int:
        with self._lock:
            return self._live_version

    @property
    def swaps(self) -> int:
        with self._lock:
            return self._swaps
