"""The continuous-batching actor-inference frontend — port of
``repro.serve.server`` (DESIGN.md §13).

``ActorServer`` is the user-scale surface of the reproduction: clients
``submit`` token prompts from any thread and get back a ``ServeHandle``
(a future); a single serve loop — background thread via ``start()`` or
foreground via ``drain()``/``serve_step()`` — runs the continuous-
batching scheduler over the batched decode engine.  Parameter hot-swap
rides the §13 double buffer: ``publish()`` stages a new model from any
thread, and the loop promotes it exactly once per step boundary, so a
training learner can retarget the policy under live traffic without
ever mixing versions inside one batch step.  With ``param_source`` (a
``ReplayService`` or a ``ReplayClient``) the loop also polls the replay
service's params channel at each step boundary and stages what it finds
(``serve/params.py::ServiceParamChannel``): a copy of the model holding
the published ``state_dict``.

The serve thread selects the server's CUDA device first: PyTorch's
current device is set per thread.

Threading contract: the scheduler and engine are touched by the serve
loop ONLY.  Cross-thread state (the submit inbox, the handle table, the
completion log) lives behind ``self._cond``; the loop drains the inbox
at each step boundary and resolves handles after eviction.  Run either
the background thread or inline stepping — not both at once.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.serve.buckets import BucketSpec
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.params import ParamDoubleBuffer, ServiceParamChannel, module_loader
from repro_torch.serve.scheduler import Completion, Scheduler

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ActorServeConfig:
    slots: int = 4                      # decode batch width
    max_len: int = 64                   # KV-cache length per slot
    buckets: Tuple[int, ...] = (16, 32)  # prompt-length padding buckets
    max_new_tokens: int = 16            # default generation budget
    idle_wait_s: float = 0.02           # loop sleep when queue+slots empty

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens}: must be >= 1")


class ServeHandle:
    """Client-side future for one submitted request."""

    def __init__(self, rid_hint: Optional[int] = None):
        self._event = threading.Event()
        self._completion: Optional[Completion] = None
        self.rid = rid_hint

    def _resolve(self, completion: Completion) -> None:
        self._completion = completion
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Completion:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request did not complete within {timeout}s")
        assert self._completion is not None
        return self._completion


class ActorServer:
    def __init__(self, cfg: ModelConfig, params: Pytree,
                 serve_cfg: ActorServeConfig = ActorServeConfig(), *,
                 params_version: int = 1, param_source: Any = None,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.engine = DecodeEngine(
            cfg, slots=serve_cfg.slots, max_len=serve_cfg.max_len,
            buckets=BucketSpec(serve_cfg.buckets), device=device)
        self.device = self.engine.device
        self.scheduler = Scheduler(self.engine)
        self.params = ParamDoubleBuffer(params, version=params_version)
        self.channel = (ServiceParamChannel(param_source, self.params,
                                            load=module_loader(params))
                        if param_source is not None else None)
        self._cond = threading.Condition()
        self._inbox: deque = deque()      # (prompt, max_new, handle, t)
        self._handles: Dict[int, ServeHandle] = {}
        self._latencies: deque = deque(maxlen=65536)  # (t_done, s, version)
        self._swap_log: deque = deque(maxlen=1024)    # (step, new version)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- client side ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None
               ) -> ServeHandle:
        """Enqueue one prompt (any thread); admission capacity is
        checked here so the caller gets the ValueError, not the loop."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        budget = (self.serve_cfg.max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        self.engine.fits(prompt.shape[0], budget)
        handle = ServeHandle()
        with self._cond:
            self._inbox.append(
                (prompt, budget, handle, time.perf_counter()))
            self._cond.notify_all()
        return handle

    def publish(self, params: Pytree, version: Optional[int] = None) -> int:
        """Stage new policy weights (any thread — typically the training
        learner); the loop swaps them in at its next step boundary."""
        v = self.params.stage(params, version)
        with self._cond:
            self._cond.notify_all()
        return v

    # -- serve loop -----------------------------------------------------------

    def serve_step(self) -> List[Completion]:
        """One step boundary: drain the inbox, poll the param channel,
        promote any staged params, then run one scheduler window."""
        with self._cond:
            while self._inbox:
                prompt, budget, handle, t = self._inbox.popleft()
                rid = self.scheduler.submit(prompt, budget, enqueued_at=t)
                handle.rid = rid
                self._handles[rid] = handle
        if self.channel is not None:
            self.channel.poll()
        params, version, swapped = self.params.swap_if_staged()
        if swapped:
            self._swap_log.append((self.scheduler.step_count + 1, version))
        completions = self.scheduler.serve_step(params, version)
        if completions:
            with self._cond:
                for c in completions:
                    self._latencies.append(
                        (c.finished_at, c.latency_s, c.params_version))
                    handle = self._handles.pop(c.rid, None)
                    if handle is not None:
                        handle._resolve(c)
        return completions

    def drain(self, timeout: Optional[float] = None) -> int:
        """Foreground mode: step until queue and slots are empty.
        Returns the number of completions resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        n = 0
        while True:
            with self._cond:
                pending = bool(self._inbox)
            if not pending and not self.scheduler.busy:
                return n
            n += len(self.serve_step())
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"drain exceeded {timeout}s "
                                   f"({n} completions so far)")

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            self.serve_step()
            with self._cond:
                idle = not self._inbox and not self.scheduler.busy
                if idle and not self._stop.is_set():
                    # periodic wake even when idle: the param channel
                    # only advances when polled
                    self._cond.wait(self.serve_cfg.idle_wait_s)

    def start(self) -> "ActorServer":
        if self._thread is not None:
            raise RuntimeError("ActorServer already started")
        self._thread = threading.Thread(
            target=self._loop, name="actor-serve", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- stats ----------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        sched = self.scheduler
        with self._cond:
            lat = [s for _, s, _ in self._latencies]
            swaps = list(self._swap_log)
        out = {
            "completed": len(lat),
            "steps": sched.step_count,
            "admissions": sched.admissions,
            "decoded_tokens": sched.decoded_tokens,
            "generated_tokens": sched.generated_tokens,
            "queued": len(sched.queue),
            "active_slots": sched.n_active,
            "params_version": self.params.version,
            "param_swaps": self.params.swaps,
            "swap_log": swaps,
            "prime_compiles": self.engine.prime_compiles,
            "decode_compiles": self.engine.decode_compiles,
            "prefill_s": sched.timings["prefill_s"],
            "decode_s": sched.timings["decode_s"],
        }
        if lat:
            out["latency_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["latency_p99_ms"] = float(np.percentile(lat, 99) * 1e3)
        return out
