"""Prompt-length padding buckets — a copy of ``repro.serve.buckets``
(DESIGN.md §13).

The serve frontend admits prompts of arbitrary length but jit-compiles
``prefill`` per *shape* — an unbounded set of prompt lengths would mean
an unbounded set of retraces (exactly the repro-lint R401 hazard class).
``BucketSpec`` is the static contract that bounds them: every prompt is
right-padded to the smallest bucket edge that holds it, so the prefill
jit cache can never grow past ``len(edges)`` entries.  Padding is safe
for position-indexed (KV-cache) families because the engine rewinds the
slot's ``pos`` to the true prompt length after prefill — every pad key
sits at a position ``>= pos`` and is overwritten by a real decode key
before the causal mask can ever see it (the §13 pad-shadowing
invariant).

Assignment is a pure function of (edges, length): deterministic, no
clocks, no state — the retrace-count test pins ``compiles == buckets
touched``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Sorted, strictly increasing prompt-length bucket edges."""

    edges: Tuple[int, ...]

    def __post_init__(self):
        if not self.edges:
            raise ValueError("BucketSpec needs at least one edge")
        edges = tuple(int(e) for e in self.edges)
        if any(e < 1 for e in edges):
            raise ValueError(f"bucket edges must be >= 1, got {edges}")
        if list(edges) != sorted(set(edges)):
            raise ValueError(
                f"bucket edges must be strictly increasing, got {edges}")
        object.__setattr__(self, "edges", edges)

    @property
    def max_prompt_len(self) -> int:
        return self.edges[-1]

    def bucket_for(self, length: int) -> int:
        """Smallest edge that holds ``length`` (the padded prefill shape)."""
        if length < 1:
            raise ValueError(f"prompt length {length} must be >= 1")
        i = bisect.bisect_left(self.edges, length)
        if i == len(self.edges):
            raise ValueError(
                f"prompt length {length} exceeds the largest bucket edge "
                f"{self.edges[-1]} — grow BucketSpec.edges or reject the "
                "request at admission")
        return self.edges[i]

    def pad(self, prompt: np.ndarray, pad_id: int = 0) -> np.ndarray:
        """Right-pad a 1-D token array to its bucket edge (shape (1, edge))."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
        edge = self.bucket_for(prompt.shape[0])
        out = np.full((1, edge), pad_id, np.int32)
        out[0, : prompt.shape[0]] = prompt
        return out
