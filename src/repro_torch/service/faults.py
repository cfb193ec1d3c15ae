"""Deterministic fault injection for the replay service (DESIGN.md §14) —
a copy of ``repro.service.faults`` (pure Python).

Long-running actor/learner fleets see connection drops, slow replies and
server crashes as a matter of course; the service's resilience contracts
(client reconnect with idempotent appends, snapshot restore, bounded
retry before clean exit) are only real if every one of those failure
modes is *drilled* by tests rather than hoped for.  A ``FaultPlan`` is a
seeded, deterministic schedule of wire-layer faults:

  * **drop-connection-after-N-frames** — the server (per connection) or
    the client (per request) closes the socket on every Nth frame,
    either *before* the frame crosses (request lost — retry must
    resend) or *after* (request applied, reply lost — retry must be
    deduplicated by the per-writer sequence number);
  * **seeded random drops** — ``drop_prob`` draws from a
    ``random.Random(seed)`` stream, so a "random" chaos run replays
    bit-identically under the same plan;
  * **delayed replies** — every Kth reply sleeps ``delay_reply_s``
    before crossing, driving client timeouts into the retry path while
    the original operation is still in flight server-side;
  * **crash-on-Kth-op** — the server dies when the Kth operation of a
    named command arrives: ``hard=True`` is a real ``os._exit`` (the
    multiprocess gang drill — SIGKILL semantics, no flush, no
    goodbye), ``hard=False`` simulates the crash in-process by closing
    the listener and every live connection (the in-process drills and
    the fig_serve ``--fault`` arm), so the restart-from-snapshot path
    runs in seconds inside one test process.

Injection sites are the wire layer only (``service/server.py``'s
handler loop and ``service/client.py``'s request path): faults tear
connections and processes, never the service's in-memory invariants —
exactly the failure model the resilience layer claims to survive.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, Optional, Tuple

#: exit code of a hard injected crash — the gang launcher treats this
#: (and only this) as the *expected* death of a server it plans to
#: restart from its shard snapshot
CRASH_EXIT_CODE = 42


class InjectedCrash(RuntimeError):
    """Raised on the soft (in-process) crash path after the server has
    been torn down — the handler thread dies without replying."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, deterministic fault schedule (all counters 1-based).

    ``drop_after_frames=N`` drops on every Nth frame (recurring);
    ``drop_before_send`` selects whether the drop loses the request
    (before dispatch) or the reply (after dispatch — the dedup drill).
    ``crash_on_op="append:40"`` kills the server when the 40th append
    frame arrives, before it is applied.
    """

    seed: int = 0
    drop_after_frames: int = 0        # 0 = never
    drop_before_send: bool = False
    drop_prob: float = 0.0            # seeded per-frame drop probability
    delay_reply_s: float = 0.0
    delay_every: int = 0              # 0 = never
    crash_on_op: str = ""             # "cmd:K", e.g. "append:40"
    hard: bool = False                # os._exit vs in-process teardown

    def __post_init__(self):
        if self.drop_after_frames < 0:
            raise ValueError(f"drop_after_frames={self.drop_after_frames}: "
                             f"must be ≥ 0")
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob={self.drop_prob}: must be in [0, 1]")
        if self.crash_on_op:
            self.crash_target  # validates the "cmd:K" shape

    @property
    def crash_target(self) -> Optional[Tuple[str, int]]:
        """(command, 1-based op count) of the scheduled crash, if any."""
        if not self.crash_on_op:
            return None
        cmd, sep, k = self.crash_on_op.partition(":")
        if not sep or not cmd:
            raise ValueError(f"crash_on_op={self.crash_on_op!r}: expected "
                             f"'cmd:K' (e.g. 'append:40')")
        try:
            kth = int(k)
        except ValueError:
            raise ValueError(f"crash_on_op={self.crash_on_op!r}: K must be "
                             f"an integer") from None
        if kth < 1:
            raise ValueError(f"crash_on_op={self.crash_on_op!r}: K must be "
                             f"≥ 1")
        return cmd, kth

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a compact ``key=value,key=value`` string —
        the CLI form the gang launcher passes to worker processes, e.g.
        ``"crash_on_op=append:40,hard=1"``."""
        kw: Dict[str, object] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, sep, val = part.partition("=")
            if not sep:
                raise ValueError(f"fault plan entry {part!r}: expected "
                                 f"key=value")
            field = {f.name: f for f in dataclasses.fields(cls)}.get(key)
            if field is None:
                raise ValueError(
                    f"unknown fault plan field {key!r}: expected one of "
                    f"{sorted(f.name for f in dataclasses.fields(cls))}")
            if field.type == "bool":
                kw[key] = val.lower() in ("1", "true", "yes")
            elif field.type == "int":
                kw[key] = int(val)
            elif field.type == "float":
                kw[key] = float(val)
            else:
                kw[key] = val
        return cls(**kw)  # type: ignore[arg-type]


class ServerFaultInjector:
    """Per-server fault state: frame counters per connection, op
    counters per command, one seeded rng stream.  Thread-safe — handler
    threads consult it concurrently."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._frames: Dict[int, int] = {}
        self._ops: Dict[str, int] = {}
        self._replies = 0
        self._rng = random.Random(plan.seed)
        self.dropped = 0
        self.delayed = 0

    def on_frame(self, conn_id: int, cmd: str) -> Optional[str]:
        """Classify one received frame: None (pass), ``"crash"``,
        ``"drop_request"`` (lose it pre-dispatch) or ``"drop_reply"``
        (apply it, lose the ack)."""
        plan = self.plan
        with self._lock:
            n = self._frames[conn_id] = self._frames.get(conn_id, 0) + 1
            k = self._ops[cmd] = self._ops.get(cmd, 0) + 1
            target = plan.crash_target
            if target is not None and cmd == target[0] and k == target[1]:
                return "crash"
            drop = bool(plan.drop_after_frames
                        and n % plan.drop_after_frames == 0)
            if plan.drop_prob:
                drop = drop or self._rng.random() < plan.drop_prob
            if drop:
                self.dropped += 1
                return ("drop_request" if plan.drop_before_send
                        else "drop_reply")
        return None

    def before_reply(self, cmd: str) -> None:
        """Injected reply latency (sleeps outside the lock)."""
        plan = self.plan
        if not (plan.delay_every and plan.delay_reply_s):
            return
        with self._lock:
            self._replies += 1
            due = self._replies % plan.delay_every == 0
            if due:
                self.delayed += 1
        if due:
            time.sleep(plan.delay_reply_s)

    def crash(self, server) -> None:
        """Execute the scheduled crash.  Hard: the process dies here
        (``os._exit`` — no atexit, no flush: SIGKILL semantics for the
        gang drill).  Soft: tear the server down in-process and kill
        this handler thread via ``InjectedCrash``."""
        if self.plan.hard:
            os._exit(CRASH_EXIT_CODE)
        server.simulate_crash()
        raise InjectedCrash(f"injected crash: {self.plan.crash_on_op}")


class ClientFaultInjector:
    """Client-side drops: every Nth *request attempt* (retries count —
    the schedule stays deterministic under its own consequences) loses
    either the request (pre-send) or the reply (post-send, the dedup
    drill).  Single client, but locked anyway: the client object allows
    cross-thread sharing."""

    def __init__(self, plan: FaultPlan):
        if plan.crash_on_op:
            raise ValueError("crash_on_op is a server-side fault; client "
                             "plans support drops and delays only")
        self.plan = plan
        self._lock = threading.Lock()
        self._requests = 0
        self._rng = random.Random(plan.seed)
        self.dropped = 0

    def on_request(self, cmd: str) -> Optional[str]:
        del cmd
        plan = self.plan
        with self._lock:
            n = self._requests = self._requests + 1
            drop = bool(plan.drop_after_frames
                        and n % plan.drop_after_frames == 0)
            if plan.drop_prob:
                drop = drop or self._rng.random() < plan.drop_prob
            if drop:
                self.dropped += 1
                return ("drop_request" if plan.drop_before_send
                        else "drop_reply")
        return None
