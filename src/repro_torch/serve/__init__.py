"""Continuous-batching actor-inference frontend — port of ``repro.serve``
(DESIGN.md §13): a request queue feeding prompt-length padding buckets,
a scheduler that admits requests into free decode slots each serve step
(continuous batching over per-slot KV caches), and double-buffered
parameter publication, fed by the replay service's params channel."""

from repro_torch.serve.buckets import BucketSpec
from repro_torch.serve.engine import DecodeEngine, DecodeState, SUPPORTED_FAMILIES
from repro_torch.serve.params import ParamDoubleBuffer, ServiceParamChannel
from repro_torch.serve.scheduler import Completion, Request, Scheduler
from repro_torch.serve.server import ActorServeConfig, ActorServer, ServeHandle

__all__ = [
    "ActorServeConfig",
    "ActorServer",
    "BucketSpec",
    "Completion",
    "DecodeEngine",
    "DecodeState",
    "ParamDoubleBuffer",
    "Request",
    "Scheduler",
    "ServeHandle",
    "ServiceParamChannel",
    "SUPPORTED_FAMILIES",
]
