"""Client side of the replay service wire protocol (DESIGN.md §11, §14) —
port of ``repro.service.client``.

One long-lived TCP connection per worker; requests are serialized on a
lock (each worker is single-threaded anyway — the lock guards against
accidental sharing).  Blocking admissions (writer backpressure, sampler
waits) happen server-side, so the client just waits on the socket; the
socket timeout therefore defaults high and bounds *deadlock*, not flow
control.

Resilience (DESIGN.md §14): every request runs inside a reconnecting
retry loop — capped exponential backoff with seeded multiplicative
jitter, bounded by an overall per-call deadline (``RetryPolicy``).  A
retry is safe for every command by construction:

  * ``append`` carries a per-writer monotonic sequence number allocated
    *before* the retry loop; the server applies each seq exactly once
    and acknowledges duplicates without re-inserting, so a lost *reply*
    (request applied, ack dropped) retries idempotently;
  * ``sample`` allocates a fresh ``sample_id`` server-side per draw —
    a retried sample is simply a new draw, and the orphaned handle ages
    out of the server's bounded outstanding map;
  * ``update_priorities`` is keyed by ``sample_id`` and the server
    tolerates stale/duplicate handles (``applied=False``);
  * ``put_params`` retried bumps the version twice — versions are
    opaque monotonic tokens, readers only ever want the newest;
  * everything else is read-only.
"""

from __future__ import annotations

import dataclasses
import pickle
import random
import socket
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.service.faults import ClientFaultInjector, FaultPlan
from repro_torch.service.server import ConnectionClosed, recv_msg, send_msg


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with multiplicative jitter and an
    overall deadline.  ``deadline=0`` disables retry (single attempt).
    Seeded: two clients with the same policy draw the same jitter
    stream, keeping chaos drills reproducible."""

    base: float = 0.05      # first sleep, seconds
    cap: float = 2.0        # per-sleep ceiling
    factor: float = 2.0     # exponential growth
    jitter: float = 0.5     # sleep *= uniform(1-j, 1+j)
    deadline: float = 60.0  # overall retry budget per call, seconds
    seed: int = 0

    def __post_init__(self):
        if self.base <= 0:
            raise ValueError(f"base={self.base}: must be > 0")
        if self.factor < 1.0:
            raise ValueError(f"factor={self.factor}: must be ≥ 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter={self.jitter}: must be in [0, 1)")
        if self.deadline < 0:
            raise ValueError(f"deadline={self.deadline}: must be ≥ 0")


def backoff_delays(policy: RetryPolicy,
                   rng: random.Random) -> Iterator[float]:
    """The shared backoff schedule: min(cap, base·factor^k), jittered."""
    attempt = 0
    while True:
        delay = min(policy.cap, policy.base * policy.factor ** attempt)
        yield delay * rng.uniform(1.0 - policy.jitter, 1.0 + policy.jitter)
        attempt += 1


class ReplayClient:
    def __init__(self, host: str, port: int, *, timeout: float = 300.0,
                 retry: Optional[RetryPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None):
        self.address = (host, port)
        self._timeout = timeout
        self._retry = RetryPolicy() if retry is None else retry
        self._rng = random.Random(self._retry.seed)
        self._fault = (ClientFaultInjector(fault_plan)
                       if fault_plan is not None else None)
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._connects = 0
        self._reconnects = 0
        self._seq_lock = threading.Lock()
        self._seqs: Dict[str, int] = {}
        self._deduped = 0
        self._acked_appends = 0
        # eager connect: constructing against a dead server fails fast
        # (gang workers gate on wait_for_service first)
        with self._lock:
            self._ensure_connected()

    @classmethod
    def from_address(cls, addr: str, **kw) -> "ReplayClient":
        host, _, port = addr.rpartition(":")
        return cls(host or "127.0.0.1", int(port), **kw)

    # -- connection management ----------------------------------------------

    def _ensure_connected(self) -> None:
        with self._lock:
            if self._sock is not None:
                return
            sock = socket.create_connection(self.address,
                                            timeout=self._timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            self._connects += 1
            if self._connects > 1:
                self._reconnects += 1

    def _disconnect(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    @property
    def reconnects(self) -> int:
        with self._lock:
            return self._reconnects

    @property
    def deduped_appends(self) -> int:
        """Appends whose retry was acknowledged-without-reinsert by the
        server's seq table — each one is a duplicate that did NOT land."""
        with self._seq_lock:
            return self._deduped

    @property
    def acked_appends(self) -> int:
        """Appends this client has received a (non-stopped) ack for —
        the client-side truth the restart drill compares against the
        server's per-writer applied counters."""
        with self._seq_lock:
            return self._acked_appends

    # -- request path -------------------------------------------------------

    def _attempt(self, cmd: str, kw: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._ensure_connected()
            action = (self._fault.on_request(cmd)
                      if self._fault is not None else None)
            if action != "drop_request":
                send_msg(self._sock, (cmd, kw))
            if action is not None:
                # injected connection loss: before the request crossed
                # (drop_request) or after it applied but before the
                # reply (drop_reply — the dedup drill)
                self._disconnect()
                raise ConnectionClosed(
                    f"{self.address[0]}:{self.address[1]} (injected)", 0, 0)
            return recv_msg(self._sock)

    def _call(self, cmd: str, **kw) -> Dict[str, Any]:
        start = time.monotonic()
        delays = backoff_delays(self._retry, self._rng)
        while True:
            try:
                reply = self._attempt(cmd, kw)
                break
            except (OSError, EOFError) as e:
                # connection-level failure (ConnectionClosed, refused,
                # reset, socket timeout): the framing state is gone —
                # drop the socket and retry the whole request on a
                # fresh connection, within the policy's deadline
                self._disconnect()
                elapsed = time.monotonic() - start
                if elapsed >= self._retry.deadline:
                    host, port = self.address
                    raise ConnectionError(
                        f"replay service at {host}:{port}: {cmd!r} still "
                        f"failing after {elapsed:.1f}s of reconnect "
                        f"attempts (deadline {self._retry.deadline:.0f}s): "
                        f"{e}") from e
                time.sleep(min(next(delays),
                               self._retry.deadline - elapsed))
        if not reply.pop("ok", False):
            raise RuntimeError(
                f"replay service rejected {cmd}: "
                f"{reply.get('error', 'unknown error')}")
        return reply

    # -- writer API ---------------------------------------------------------

    def append(self, writer_id: str, items: Any, *,
               returns: Optional[List[float]] = None,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        items = as_numpy(items)
        # the seq is allocated BEFORE the retry loop: every resend of
        # this logical append carries the same number, which is what
        # lets the server apply it exactly once
        with self._seq_lock:
            seq = self._seqs[writer_id] = self._seqs.get(writer_id, 0) + 1
        reply = self._call("append", writer_id=writer_id, items=items,
                           returns=returns, timeout=timeout, seq=seq)
        with self._seq_lock:
            if reply.get("deduped"):
                self._deduped += 1
            if reply.get("applied"):
                # counts exactly-once application acks (dedup replies
                # included — the original applied, this is its ack), so
                # this total matches the server's per-writer table even
                # when a stop() races the final append
                self._acked_appends += 1
        return reply

    # -- learner API --------------------------------------------------------

    def sample(self, batch: int, beta: float = 0.4, *,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        return self._call("sample", batch=batch, beta=float(beta),
                          timeout=timeout)

    def update_priorities(self, sample_id: int,
                          td_errors: np.ndarray) -> bool:
        return self._call("update_priorities", sample_id=sample_id,
                          td_errors=np.asarray(td_errors))["applied"]

    # -- param channel ------------------------------------------------------

    def put_params(self, params: Any) -> int:
        blob = pickle.dumps(as_numpy(params),
                            protocol=pickle.HIGHEST_PROTOCOL)
        return self._call("put_params", blob=blob)["version"]

    def get_params(self, min_version: int = 1,
                   timeout: Optional[float] = None) -> Dict[str, Any]:
        reply = self._call("get_params", min_version=min_version,
                           timeout=timeout)
        if reply.get("blob") is not None:
            reply["params"] = pickle.loads(reply["blob"])
        return reply

    # -- lifecycle + stats --------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return self._call("stats")["stats"]

    def stop(self) -> None:
        self._call("stop")

    def ping(self) -> bool:
        return self._call("ping")["pong"]

    def close(self) -> None:
        self._disconnect()


def as_numpy(tree: Any) -> Any:
    """The wire form of a payload: tensors (on any device) as numpy arrays,
    a module as its ``state_dict``, through dicts, lists and tuples.
    numpy has no bf16, so a bf16 tensor crosses widened to f32 (exact;
    ``serve.params.load_params_`` casts it back)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_numpy(v) for v in tree)
    return np.asarray(tree)


def wait_for_service(host: str, port: int, timeout: float = 30.0) -> None:
    """Poll until the server accepts (gang startup ordering).  Rides
    the same capped-exponential backoff as the client's retry loop —
    fast first probes, then settling toward the cap instead of hammering
    a fixed-rate poll."""
    policy = RetryPolicy(base=0.05, cap=1.0, jitter=0.25,
                         deadline=timeout)
    delays = backoff_delays(policy, random.Random(policy.seed))
    deadline = time.monotonic() + timeout
    while True:
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return
        except OSError:
            now = time.monotonic()
            if now >= deadline:
                raise RuntimeError(
                    f"replay service at {host}:{port} not reachable "
                    f"within {timeout:.0f}s") from None
            time.sleep(min(next(delays), deadline - now))
