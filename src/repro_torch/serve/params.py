"""Double-buffered parameter publication for the serve path — port of
``repro.serve.params`` (DESIGN.md §13).

The learner updates fresh params on its own clock, the actor acts on a
stable copy, and the handoff happens at the ``serve_step`` boundary:
``stage`` may be called from any thread at any time (it only touches the
*staged* half), and the serve loop calls ``swap_if_staged`` exactly once
per step, so one batch step never mixes two parameter versions.  The
swap is a reference flip, not a copy.

``ServiceParamChannel`` plugs the replay service's versioned params
channel (service/server.py ``put_params``/``get_params``) in as the
publisher: a training learner pushes ``params_for_acting`` to the replay
server it already talks to, and the actor frontend polls the same
channel — no second wire protocol.  Works against both the in-process
``ReplayService`` (blob bytes) and the TCP ``ReplayClient``
(pre-unpickled ``params``).  What crosses is numpy (a module's
``state_dict``, service/client.py ``as_numpy``); ``module_loader`` turns
it back into a module on the receiver's device.
"""

from __future__ import annotations

import copy
import pickle
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

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
    def staged_version(self) -> Optional[int]:
        with self._lock:
            return self._staged[0] if self._staged else None

    @property
    def swaps(self) -> int:
        with self._lock:
            return self._swaps


@torch.no_grad()
def load_params_(module: nn.Module, tree: Dict[str, np.ndarray]) -> nn.Module:
    """Copy a numpy ``state_dict`` into ``module``'s own tensors, in place
    (each cast to the tensor's dtype and device); the key sets must
    match."""
    own = module.state_dict()
    if set(own) != set(tree):
        diff = sorted(set(own) ^ set(tree))
        raise ValueError(f"params tree does not match the module: {diff[:5]}")
    for k, t in own.items():
        t.copy_(torch.as_tensor(np.asarray(tree[k])))
    return module


def module_loader(template: nn.Module) -> Callable[[Any], nn.Module]:
    """``load(tree) → module``: a fresh copy of ``template`` holding the
    numpy ``state_dict`` ``tree`` (a module passes through), so a staged
    version never shares tensors with the live one."""
    def load(tree: Any) -> nn.Module:
        if isinstance(tree, nn.Module):
            return tree
        return load_params_(copy.deepcopy(template), tree)
    return load


class ServiceParamChannel:
    """Poll the replay service's versioned param channel into a
    ``ParamDoubleBuffer``.  ``source`` is duck-typed: anything with
    ``get_params(min_version=..., timeout=...)`` — the in-process
    ``ReplayService`` or the TCP ``ReplayClient``.  ``load`` maps the
    channel's tree to what the buffer holds (``module_loader`` for a
    module; by default the tree itself).

    Degradation contract (DESIGN.md §14): a channel outage — the
    service unreachable, the connection torn mid-poll, the retry budget
    exhausted — must never take the serve loop down with it.  ``poll``
    swallows connection-level failures, leaves the double buffer on the
    last-good params, and counts the outage: ``stale_polls`` is the
    consecutive-failure staleness signal (reset on the next successful
    round trip), ``outages`` the lifetime total, ``last_error`` the
    most recent failure rendered for operators."""

    def __init__(self, source: Any, buffer: ParamDoubleBuffer,
                 load: Optional[Callable[[Any], Any]] = None):
        if not callable(getattr(source, "get_params", None)):
            raise TypeError(f"param source {type(source).__name__} has no get_params: "
                            "pass a ReplayService or a ReplayClient")
        self.source = source
        self.buffer = buffer
        self.load = load or (lambda tree: tree)
        self._seen = buffer.version
        self.outages = 0          # lifetime connection-level poll failures
        self.stale_polls = 0      # consecutive failures — staleness signal
        self.last_error: Optional[str] = None

    def poll(self) -> bool:
        """Non-blocking pull: stage the channel's tree iff it carries a
        version newer than anything we've seen.  Returns True on a new
        stage; False on no-news *and* on outage (see class docstring —
        check ``stale_polls`` to tell them apart)."""
        floor = self._seen
        staged = self.buffer.staged_version
        if staged is not None:
            floor = max(floor, staged)
        try:
            reply = self.source.get_params(min_version=floor + 1, timeout=0.0)
        except TimeoutError:
            # in-process source: no newer version yet — contact was fine
            self.stale_polls = 0
            return False
        except (ConnectionError, EOFError, OSError) as e:
            self.outages += 1
            self.stale_polls += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        except RuntimeError as e:
            # the TCP client surfaces server-side errors as RuntimeError
            # replies; a server-side TimeoutError is the quiet-channel
            # case, anything else is a real outage of the channel
            if "TimeoutError" in str(e):
                self.stale_polls = 0
                return False
            self.outages += 1
            self.stale_polls += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        self.stale_polls = 0
        if reply.get("stopped") and reply.get("version", 0) <= floor:
            return False
        version = int(reply["version"])
        if version <= floor:
            return False
        params = reply.get("params")
        if params is None:
            params = pickle.loads(reply["blob"])
        self._seen = version
        self.buffer.stage(self.load(params), version)
        return True

    def stats(self) -> dict:
        return {"seen_version": self._seen, "outages": self.outages,
                "stale_polls": self.stale_polls,
                "last_error": self.last_error}
