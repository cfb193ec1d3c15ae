"""Shard addressing for the replay service (DESIGN.md §11) — a copy of
``repro.service.router`` (pure Python).

A writer's append has to land on exactly one shard, and the choice must
be stable enough that a writer's transitions spread evenly without any
cross-shard coordination.  Two policies:

- ``hash``: shard = hash(writer_id) — every writer owns one shard for
  its whole lifetime (shard-affinity: a writer's appends serialize on
  one shard's ledger, so its own transitions are never reordered across
  shards).  With ≥ n_shards writers this is the fleet default.
- ``round_robin``: shard = next in cyclic order per append — spreads a
  *single* writer across all shards (the in-process executor and
  few-writer gangs would otherwise leave shards empty past warmup).
"""

from __future__ import annotations

import itertools
import threading
import zlib


class Router:
    POLICIES = ("hash", "round_robin")

    def __init__(self, n_shards: int, policy: str = "hash"):
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards}: must be ≥ 1")
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r}: expected one of "
                f"{self.POLICIES}")
        self.n_shards = n_shards
        self.policy = policy
        self._rr = itertools.count()
        self._lock = threading.Lock()

    def route(self, writer_id: str) -> int:
        """Shard index for one append by ``writer_id``."""
        if self.policy == "hash":
            # stable across processes/runs (python's hash() is salted)
            return zlib.crc32(writer_id.encode()) % self.n_shards
        with self._lock:
            return next(self._rr) % self.n_shards

    def describe(self) -> str:
        return f"{self.policy} over {self.n_shards} shard(s)"
