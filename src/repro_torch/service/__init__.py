"""Replay-as-a-service (DESIGN.md §11) — port of ``repro.service``.

The transaction layer of ``core/replay.py`` recast as a standalone
service: N independent ``PrioritizedReplay`` shards behind a router,
multi-writer lazy appends with one tree-propagation ``flush`` per
admission window, and a ``RateLimiter`` that generalizes the loop's
``RatioSchedule`` into explicit flow control between decoupled actor
and learner processes.  The shards live on the card unless the service
is given ``device="cpu"``.
"""

from repro_torch.service.faults import (ClientFaultInjector, FaultPlan,
                                        InjectedCrash, ServerFaultInjector)
from repro_torch.service.rate_limiter import RateLimiter, ServiceStopped
from repro_torch.service.router import Router
from repro_torch.service.server import (ConnectionClosed, ReplayService,
                                        ReplayServiceConfig, serve)
from repro_torch.service.client import (ReplayClient, RetryPolicy,
                                        backoff_delays, wait_for_service)
from repro_torch.service.executor import ServiceExecutor

__all__ = [
    "ClientFaultInjector",
    "ConnectionClosed",
    "FaultPlan",
    "InjectedCrash",
    "RateLimiter",
    "RetryPolicy",
    "ServerFaultInjector",
    "ServiceStopped",
    "Router",
    "ReplayService",
    "ReplayServiceConfig",
    "ReplayClient",
    "ServiceExecutor",
    "backoff_delays",
    "serve",
    "wait_for_service",
]
