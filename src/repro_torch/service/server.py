"""The replay server (DESIGN.md §11) — port of ``repro.service.server``.

``ReplayService`` is the transaction layer of ``core/replay.py`` recast
as a long-lived service: N independent ``PrioritizedReplay`` shards
addressed by a ``Router``, written by any number of writers through the
lazy ledger (every append is leaf-only + ledger bump; the interior
rebuild happens in **one** ``flush`` per shard per admission window —
the window boundary is the next sample that touches the shard), and
sampled by learners with importance weights computed against the
*global* cross-shard priority distribution (the stratified sample of
``ShardedPrioritizedReplay``, with the mesh's sums and max replaced by
host-side reductions over the shard list: ``stratified_sample``).

Flow control is delegated to the ``RateLimiter``: append admissions
back-pressure writers, sample admissions block the learner, and the
realized samples-per-insert ratio is pinned to the configured one.

The shards live on the service's device (CUDA unless ``device="cpu"``),
so on the card every sample runs the replay kernels: the descent and the
gather of every leaf (#1, #2), or the fused sample+gather (#3) with
``fused_sample_gather``.  The server's handler threads run these ops
concurrently with the wire: every shard mutation runs under one lock,
and every op enters the service's device first (a new thread's current
CUDA device is its own).  A sample copies the drawn rows and weights to
host memory for the reply: one device→host copy a storage leaf plus one
for the weights, each a host sync, which the wire needs by design
(``stats()["sample_host_copies"]`` counts them).

The wire layer is deliberately minimal: length-prefixed pickles over
localhost TCP (the gang launcher binds 127.0.0.1 and every worker runs on
the same host — a research harness transport, not an authenticated RPC
stack).  Every numerical payload crosses as numpy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pickle
import socket
import socketserver
import struct
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.replay import PrioritizedReplay, ReplayConfig, ReplayState, Storage
from repro_torch.device import DeviceLike
from repro_torch.service.faults import FaultPlan, InjectedCrash, ServerFaultInjector
from repro_torch.service.rate_limiter import RateLimiter, ServiceStopped
from repro_torch.service.router import Router


@dataclasses.dataclass(frozen=True)
class ReplayServiceConfig:
    capacity_per_shard: int
    n_shards: int = 1
    fanout: int = 128
    alpha: float = 0.6
    eps: float = 1e-6
    backend: Optional[str] = None   # "cuda" | "torch"; None → by device
    fused_sample_gather: bool = False   # #3 in place of #1 + #2
    router: str = "hash"            # Router.POLICIES
    seed: int = 0                   # server-side sample generator

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards={self.n_shards}: must be ≥ 1")
        if self.capacity_per_shard < 1:
            raise ValueError(
                f"capacity_per_shard={self.capacity_per_shard}: must be ≥ 1")


def _defer_max(w_max: torch.Tensor) -> torch.Tensor:
    """``max_across`` hook that leaves a shard's weights unnormalized
    (w / 1 is exact): the global max is taken over the shard list."""
    return torch.ones_like(w_max)


def stratified_sample(replay: PrioritizedReplay, states: Sequence[ReplayState],
                      us: Sequence[torch.Tensor], beta: float
                      ) -> Tuple[List[torch.Tensor], Storage, torch.Tensor]:
    """``len(us[i])`` draws from flushed shard ``i`` at the uniforms
    ``us[i]`` → (indices per shard, rows concatenated in shard order,
    importance weights).  The weights follow the global distribution: the
    shards' summed root and count enter each shard's ``sample``, and all
    are divided by the max over every shard's weights.  One shard is
    ``PrioritizedReplay.sample`` itself."""
    if len(states) == 1:
        idx, items, w = replay.sample(states[0], None, us[0].shape[0], beta, u=us[0])
        return [idx], items, w
    g_tot = sum(s.tree[0] for s in states)
    g_cnt = torch.full((), float(sum(s.count for s in states)), dtype=torch.float32,
                       device=replay.device)
    idxs, parts, ws = [], [], []
    for s, u in zip(states, us):
        idx, items, w = replay.sample(s, None, u.shape[0], beta, u=u, global_total=g_tot,
                                      global_count=g_cnt, max_across=_defer_max)
        idxs.append(idx)
        parts.append(items)
        ws.append(w)
    w = torch.cat(ws)
    w = w / torch.clamp(w.max(), min=1e-12)
    items = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return idxs, items, w


class ReplayService:
    """Host-side service core.  Thread-safe: every shard mutation runs
    under one lock; blocking admissions happen *outside* the lock in the
    ``RateLimiter``."""

    def __init__(self, config: ReplayServiceConfig, example_item: Storage,
                 rate_limiter: Optional[RateLimiter] = None, device: DeviceLike = "cuda"):
        self.config = config
        self.replay = PrioritizedReplay(
            ReplayConfig(capacity=config.capacity_per_shard, fanout=config.fanout,
                         alpha=config.alpha, eps=config.eps, backend=config.backend,
                         fused_sample_gather=config.fused_sample_gather),
            example_item, device=device)
        self.device = self.replay.device
        self.router = Router(config.n_shards, config.router)
        self.limiter = rate_limiter
        self.states: List[ReplayState] = [self.replay.init()
                                          for _ in range(config.n_shards)]
        self._lock = threading.RLock()
        self._stopped = threading.Event()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        # counters + learner-facing bookkeeping
        self._inserts = 0
        self._samples = 0
        self._sample_count = 0
        self._host_copies = 0
        self._outstanding: Dict[int, Tuple[torch.Tensor, ...]] = {}
        # idempotent appends (DESIGN.md §14): per-writer last-applied
        # sequence number + the set of seqs currently being applied.  A
        # retry for an in-flight seq parks on the condition until the
        # original lands, then reads the dedup verdict — this closes the
        # retry-while-original-parked race without double-applying.
        self._seq_cond = threading.Condition(self._lock)
        self._writer_seq: Dict[str, int] = {}
        self._writer_appends: Dict[str, int] = {}
        self._inflight: Dict[str, Set[int]] = {}
        self._dup_appends = 0
        self._appends = 0
        # durability: optional snapshot sink (attach_snapshots)
        self._ckpt = None
        self._snap_every = 0
        self._snap_step = 0
        self._snapshots_taken = 0
        self._restored_step: Optional[int] = None
        # param channel (PUT/GET with versions; blobs are opaque bytes)
        self._params_cond = threading.Condition()
        self._params_blob: Optional[bytes] = None
        self._params_version = 0
        # writer-reported finished-episode returns (progress metric)
        self._returns: deque = deque(maxlen=256)

    def _on_device(self):
        """Make the service's device current in the calling thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- write path ---------------------------------------------------------

    def append(self, writer_id: str, items: Storage, *,
               returns: Optional[List[float]] = None,
               timeout: Optional[float] = None,
               seq: Optional[int] = None) -> Dict[str, Any]:
        """One writer transaction: rate-limited admission, route to a
        shard, lazy leaf-only append (sampleable at the shard's next
        flush).  Returns progress the writer needs (global insert clock
        for its ε-schedule, current params version, stop flag) so the
        common actor loop costs one round trip per batch.

        ``seq`` (per-writer, monotonic, allocated client-side *before*
        the retry loop) makes the transaction idempotent: a seq at or
        below the writer's last applied one is acknowledged without
        re-inserting, so retry-after-reconnect — including the case
        where the reply, not the request, was lost — applies exactly
        once."""
        batch = int(next(iter(items.values())).shape[0])
        if seq is not None:
            dup = self._admit_seq(writer_id, int(seq), timeout)
            if dup is not None:
                return dup
        try:
            if self.limiter is not None:
                try:
                    self.limiter.await_insert(batch, timeout)
                except ServiceStopped:
                    return {"stopped": True, "inserts": self.total_inserts(),
                            "params_version": self.params_version()}
            shard = self.router.route(writer_id)
            with self._on_device():
                rows = {k: torch.as_tensor(v).to(self.device) for k, v in items.items()}
                with self._lock:
                    self.states[shard] = self.replay.append(self.states[shard], rows,
                                                            lazy=True)
                    self._inserts += batch
                    self._appends += 1
                    if seq is not None:
                        self._writer_seq[writer_id] = int(seq)
                        self._writer_appends[writer_id] = (
                            self._writer_appends.get(writer_id, 0) + 1)
                    if returns:
                        self._returns.extend(float(r) for r in returns)
                    total = self._inserts
                    if self._snap_every and self._appends % self._snap_every == 0:
                        # durable ack: the snapshot lands before the reply,
                        # so an acked append is a restored append — this
                        # is what makes per-writer counters bit-identical
                        # across a server crash (snapshot_every_appends=1
                        # in the drills; larger periods trade the tail of
                        # un-acked work for throughput, and dedup-on-retry
                        # still keeps the restore exactly-once)
                        self._save_snapshot_locked()
        finally:
            if seq is not None:
                self._release_seq(writer_id, int(seq))
        # "applied" is the exactly-once ack: set on real application and
        # on dedup (the original applied; this reply is its ack), absent
        # on the not-applied ServiceStopped path — clients count acked
        # appends off it, and the restart drill compares those counts
        # against the server's per-writer applied table
        return {"stopped": self._stopped.is_set(), "shard": shard,
                "applied": True, "inserts": total,
                "params_version": self.params_version()}

    def _admit_seq(self, writer_id: str, seq: int,
                   timeout: Optional[float]) -> Optional[Dict[str, Any]]:
        """Claim ``seq`` for application, or return the dedup reply if
        it already applied.  A retry that races its own original (still
        parked in limiter backpressure) waits here for the verdict."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._seq_cond:
            while True:
                if seq <= self._writer_seq.get(writer_id, 0):
                    self._dup_appends += 1
                    return {"stopped": self._stopped.is_set(),
                            "deduped": True, "applied": True,
                            "inserts": self._inserts,
                            "params_version": self.params_version()}
                inflight = self._inflight.setdefault(writer_id, set())
                if seq not in inflight:
                    inflight.add(seq)
                    return None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"append seq {seq} from writer {writer_id!r} "
                        f"still in flight after {timeout}s")
                self._seq_cond.wait(remaining)

    def _release_seq(self, writer_id: str, seq: int) -> None:
        with self._seq_cond:
            inflight = self._inflight.get(writer_id)
            if inflight is not None:
                inflight.discard(seq)
                if not inflight:
                    self._inflight.pop(writer_id, None)
            self._seq_cond.notify_all()

    # -- read path ----------------------------------------------------------

    def sample(self, batch: int, beta: float = 0.4, *,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        """One learner read: rate-limited admission, the admission-window
        flush of every shard with pending writes, then the stratified draw
        (B/N a shard) with globally normalized weights.  Returns a
        ``sample_id`` handle the learner echoes into
        ``update_priorities`` — the service keeps the (shard → indices)
        map server-side so priorities route back without the learner
        knowing the sharding."""
        n = self.config.n_shards
        if batch % n:
            raise ValueError(
                f"sample batch={batch} must divide evenly over "
                f"n_shards={n} (stratified sampling draws B/N per shard)")
        if self.limiter is not None:
            try:
                self.limiter.await_sample(batch, timeout)
            except ServiceStopped:
                return {"stopped": True}
        per = batch // n
        with self._on_device():
            with self._lock:
                self.states[:] = [self.replay.flush(s) for s in self.states]
                us = [torch.rand((per,), generator=self._gen, device=self.device)
                      for _ in range(n)]
                idxs, items, w = stratified_sample(self.replay, self.states, us, beta)
                self._sample_count += 1
                self._samples += batch
                self._host_copies += len(items) + 1
                sid = self._sample_count
                self._outstanding[sid] = tuple(idxs)
                if len(self._outstanding) > 64:
                    # a learner that never writes priorities back leaks
                    # handles; drop the oldest (write-after-read is already
                    # tolerated, a dropped update is a stale priority)
                    self._outstanding.pop(next(iter(self._outstanding)))
            # the rows are fresh tensors (the gathers copy), so the host
            # copies, each a sync, need not hold the lock
            items = {k: v.cpu().numpy() for k, v in items.items()}
            weights = w.cpu().numpy()
        return {"stopped": self._stopped.is_set(), "sample_id": sid,
                "items": items, "weights": weights}

    def update_priorities(self, sample_id: int,
                          td_errors: np.ndarray) -> Dict[str, Any]:
        with self._on_device():
            td = torch.as_tensor(np.asarray(td_errors, np.float32)).to(self.device)
            with self._lock:
                idxs = self._outstanding.pop(sample_id, None)
                if idxs is None:
                    return {"applied": False}  # handle aged out — stale is ok
                off = 0
                for shard, idx in enumerate(idxs):
                    chunk = td[off:off + idx.shape[0]]
                    off += idx.shape[0]
                    self.states[shard] = self.replay.update_priorities(
                        self.states[shard], idx, chunk, lazy=True)
        return {"applied": True}

    # -- durability (DESIGN.md §14) -----------------------------------------

    def attach_snapshots(self, manager, *, every_appends: int = 50) -> None:
        """Snapshot the full service state into ``manager`` (a
        ``checkpoint.CheckpointManager``) every N applied appends.
        ``every_appends=1`` gives durable acks — insert → snapshot →
        ack — which the restart drills rely on for exactly-once."""
        if every_appends < 1:
            raise ValueError(f"every_appends={every_appends}: must be ≥ 1")
        with self._lock:
            self._ckpt = manager
            self._snap_every = every_appends

    def _snapshot_tensors(self) -> Dict[str, torch.Tensor]:
        """The shards' tensors by name, and the sample generator's state."""
        out = {}
        for i, s in enumerate(self.states):
            out[f"shard{i}/tree"] = s.tree
            out[f"shard{i}/max_priority"] = s.max_priority
            out.update({f"shard{i}/storage/{k}": v for k, v in s.storage.items()})
        out["sample_gen"] = self._gen.get_state()
        return out

    def _save_snapshot_locked(self) -> int:  # repro-lint: disable=L301(every caller holds self._lock — the _locked suffix is the contract)
        self._snap_step += 1
        meta = {
            "inserts": self._inserts,
            "samples": self._samples,
            "sample_count": self._sample_count,
            "appends": self._appends,
            "dup_appends": self._dup_appends,
            "writer_seq": dict(self._writer_seq),
            "writer_appends": dict(self._writer_appends),
            "returns": [float(r) for r in self._returns],
            "params_version": self.params_version(),
            "shards": [{"head": s.head, "count": s.count, "pending": s.pending}
                       for s in self.states],
            "limiter": (None if self.limiter is None
                        else self.limiter.stats()),
        }
        extra = {"service.json": json.dumps(meta).encode()}
        with self._params_cond:
            blob = self._params_blob
        if blob is not None:
            extra["params.bin"] = blob
        self._ckpt.save(self._snap_step, self._snapshot_tensors(), extra=extra)
        self._snapshots_taken += 1
        return self._snap_step

    def save_snapshot(self) -> int:
        """Force one snapshot now (requires ``attach_snapshots``)."""
        with self._lock:
            if self._ckpt is None:
                raise RuntimeError("no snapshot manager attached — call "
                                   "attach_snapshots first")
            return self._save_snapshot_locked()

    def restore_snapshot(self, manager) -> Optional[int]:
        """Rebuild the service from the latest snapshot in ``manager``:
        shard states (tensors restored in place, the host-int ``head``,
        ``count`` and ``pending`` from the metadata), per-writer seq tables
        (so dedup keeps rejecting already-acked retries from before the
        crash), the sample generator's state, limiter debt counters, and
        the last published params blob + version.  Returns the restored
        step, or None when the directory is empty (cold start)."""
        with self._on_device(), self._lock:
            example = self._snapshot_tensors()
            step, tensors = manager.restore_latest(example)
            if step is None:
                return None
            meta = json.loads(manager.read_extra(step, "service.json").decode())
            blob = manager.read_extra(step, "params.bin")
            self._gen.set_state(tensors["sample_gen"])
            self.states[:] = [dataclasses.replace(s, head=int(m["head"]), count=int(m["count"]),
                                                  pending=int(m["pending"]))
                              for s, m in zip(self.states, meta["shards"])]
            self._inserts = int(meta["inserts"])
            self._samples = int(meta["samples"])
            self._sample_count = int(meta["sample_count"])
            self._appends = int(meta["appends"])
            self._dup_appends = int(meta["dup_appends"])
            self._writer_seq = {k: int(v)
                                for k, v in meta["writer_seq"].items()}
            self._writer_appends = {k: int(v)
                                    for k, v in meta["writer_appends"].items()}
            self._returns.clear()
            self._returns.extend(float(r) for r in meta["returns"])
            self._snap_step = step
            self._restored_step = step
        if self.limiter is not None and meta["limiter"] is not None:
            self.limiter.restore_counts(int(meta["limiter"]["inserts"]),
                                        int(meta["limiter"]["samples"]))
        with self._params_cond:
            if blob is not None:
                self._params_blob = blob
            self._params_version = int(meta["params_version"])
            self._params_cond.notify_all()
        return step

    # -- param channel ------------------------------------------------------

    def put_params(self, blob: bytes) -> int:
        with self._params_cond:
            self._params_blob = blob
            self._params_version += 1
            self._params_cond.notify_all()
            return self._params_version

    def get_params(self, min_version: int = 1,
                   timeout: Optional[float] = None) -> Dict[str, Any]:
        with self._params_cond:
            if not self._params_cond.wait_for(
                    lambda: (self._params_version >= min_version
                             or self._stopped.is_set()),
                    timeout):
                raise TimeoutError(
                    f"get_params: version ≥ {min_version} not published "
                    f"within {timeout}s (at {self._params_version})")
            return {"version": self._params_version,
                    "blob": self._params_blob,
                    "stopped": self._stopped.is_set()}

    def params_version(self) -> int:
        with self._params_cond:
            return self._params_version

    # -- lifecycle + stats --------------------------------------------------

    def stop(self) -> None:
        self._stopped.set()
        if self.limiter is not None:
            self.limiter.stop()
        with self._params_cond:
            self._params_cond.notify_all()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def total_inserts(self) -> int:
        with self._lock:
            return self._inserts

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            recent = list(self._returns)
            out = {
                "inserts": self._inserts,
                "samples": self._samples,
                "sample_calls": self._sample_count,
                "sample_host_copies": self._host_copies,
                "appends": self._appends,
                "dup_appends": self._dup_appends,
                "writer_seq": dict(self._writer_seq),
                "writer_appends": dict(self._writer_appends),
                "snapshots": self._snapshots_taken,
                "restored_step": self._restored_step,
                "per_shard_count": [s.count for s in self.states],
                "params_version": self.params_version(),
                "mean_recent_return": (float(np.mean(recent))
                                       if recent else 0.0),
                "n_returns": len(recent),
                "stopped": self._stopped.is_set(),
                "router": self.router.describe(),
                "device": str(self.device),
                "tree_backend": self.replay.ops.name,
            }
        if self.limiter is not None:
            out["rate_limiter"] = self.limiter.stats()
        return out


# -- wire layer (length-prefixed pickle over localhost TCP) ------------------

_LEN = struct.Struct("!Q")


class ConnectionClosed(ConnectionError):
    """Peer closed the connection — with where and how far through the
    frame it happened, so the retry layer can classify (mid-frame close
    after a send means the reply was lost and the request *may have
    applied*: only idempotent operations may be retried)."""

    def __init__(self, peer: str, bytes_read: int, expected: int):
        self.peer = peer
        self.bytes_read = bytes_read
        self.expected = expected
        if bytes_read:
            detail = (f"mid-frame ({bytes_read}/{expected} bytes read)")
        else:
            detail = "before a frame"
        super().__init__(
            f"replay-service peer {peer} closed connection {detail}")


def _peer_name(sock: socket.socket) -> str:
    try:
        host, port = sock.getpeername()[:2]
        return f"{host}:{port}"
    except (OSError, ValueError):
        # closed socket, or a non-INET family (unix socketpair in tests)
        return "unknown"


def send_msg(sock: socket.socket, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed(_peer_name(sock), len(buf), n)
        buf.extend(chunk)
    return bytes(buf)


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server.track(self.request)  # type: ignore[attr-defined]

    def finish(self):
        self.server.untrack(self.request)  # type: ignore[attr-defined]

    def handle(self):  # one connection = one client, many requests
        service: ReplayService = self.server.service  # type: ignore
        injector: Optional[ServerFaultInjector] = (
            self.server.fault_injector)  # type: ignore[attr-defined]
        conn_id = id(self.request)
        while True:
            try:
                cmd, kw = recv_msg(self.request)
            except (ConnectionError, EOFError):
                return
            action = (injector.on_frame(conn_id, cmd)
                      if injector is not None else None)
            if action == "crash":
                injector.crash(self.server)  # hard: no return; soft: raises
            if action == "drop_request":
                self._drop()  # request lost before dispatch
                return
            try:
                reply = self._dispatch(service, cmd, kw)
                reply.setdefault("ok", True)
            except Exception as e:  # noqa: BLE001 — cross the wire, don't die
                reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if action == "drop_reply":
                self._drop()  # request applied, ack lost — the dedup drill
                return
            if injector is not None:
                injector.before_reply(cmd)
            try:
                send_msg(self.request, reply)
            except (ConnectionError, BrokenPipeError):
                return

    def _drop(self):
        try:
            self.request.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.request.close()
        except OSError:
            pass

    @staticmethod
    def _dispatch(service: ReplayService, cmd: str, kw: dict) -> dict:
        if cmd == "append":
            return service.append(**kw)
        if cmd == "sample":
            return service.sample(**kw)
        if cmd == "update_priorities":
            return service.update_priorities(**kw)
        if cmd == "put_params":
            return {"version": service.put_params(**kw)}
        if cmd == "get_params":
            return service.get_params(**kw)
        if cmd == "stats":
            return {"stats": service.stats()}
        if cmd == "stop":
            service.stop()
            return {"stopped": True}
        if cmd == "ping":
            return {"pong": True}
        raise ValueError(f"unknown replay-service command {cmd!r}")


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # blocking admissions park handler threads; the default request
    # queue of 5 is fine (one connection per worker, long-lived)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fault_injector: Optional[ServerFaultInjector] = None
        self.crashed = threading.Event()
        self._conn_lock = threading.Lock()
        self._conns: Set[socket.socket] = set()

    def track(self, sock: socket.socket) -> None:
        with self._conn_lock:
            self._conns.add(sock)

    def untrack(self, sock: socket.socket) -> None:
        with self._conn_lock:
            self._conns.discard(sock)

    def shutdown_connections(self) -> None:
        """Sever every live client connection (their next recv raises
        ``ConnectionClosed``)."""
        with self._conn_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def simulate_crash(self) -> None:
        """In-process stand-in for a process kill: stop accepting,
        close the listener, sever every connection.  The service
        object's in-memory state is abandoned exactly as a real crash
        abandons it — a restart must come from the snapshot.

        ``crashed`` is set only after the listener is closed: a restart
        monitor waking on the event may rebind the port immediately."""
        self.shutdown()  # blocks until serve_forever exits (≤ poll tick)
        try:
            self.server_close()
        except OSError:
            pass
        self.crashed.set()
        self.shutdown_connections()

    def handle_error(self, request, client_address):
        # injected crashes and torn connections are expected events in
        # the fault drills — everything else keeps the stock traceback
        exc = sys.exc_info()[1]
        if isinstance(exc, (InjectedCrash, ConnectionError,
                            BrokenPipeError)):
            return
        if isinstance(exc, OSError) and self.crashed.is_set():
            # a simulated crash severs sockets under live handlers;
            # their dying sends (EBADF) are the drill, not a bug
            return
        super().handle_error(request, client_address)


def serve(service: ReplayService, host: str = "127.0.0.1", port: int = 0,
          *, fault_plan: Optional[FaultPlan] = None) -> Tuple[_Server, int]:
    """Start serving on a background thread; returns (server, bound
    port).  ``port=0`` lets the OS pick — the gang launcher passes the
    bound port to the workers.  Call ``server.shutdown()`` to stop.
    ``fault_plan`` arms deterministic wire-layer fault injection
    (``service/faults.py``) for the chaos drills."""
    server = _Server((host, port), _Handler)
    server.service = service  # type: ignore[attr-defined]
    if fault_plan is not None:
        server.fault_injector = ServerFaultInjector(fault_plan)
    thread = threading.Thread(target=server.serve_forever,
                              name="replay-service", daemon=True)
    thread.start()
    return server, server.server_address[1]
