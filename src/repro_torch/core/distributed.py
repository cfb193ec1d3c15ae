"""Sharded replay buffer across a mesh of ranks — port of
``repro.core.distributed``'s ``ShardedReplayConfig`` and
``ShardedPrioritizedReplay`` — and ``initialize_distributed``, the
wall-clock gang's handshake (``launch/multiprocess.py``).

The paper's single shared buffer becomes one shard per rank: local storage
and a local K-ary sum tree.  Sampling is *stratified*: each learner shard
draws B/D items from its own tree (no transitions cross the wire), and the
importance weights follow the **global** priority distribution,

    inclusion prob of item i on shard d:  q(i) = (B/D) · p_i / S_d
    PER-consistent weight:                w_i ∝ (N_glob · p_i / S_glob)^(-β)

where S_d is the shard's root and S_glob, N_glob come from one stacked
``[root, count]`` all-reduce per mesh axis (8 bytes); the ``w / max w``
normalizer is a max over every shard's draws (one scalar all-reduce MAX
per axis).  Inserts, flushes and priority updates are shard-local.

The count is a host int, as in ``core/replay.py``; the global count
travels in the stats collective as an f32 scalar, as in the reference.
The mesh is passed to the calls that reduce (``launch/mesh.py``).

``initialize_distributed`` joins this process to a gang of OS processes
as one rank of a ``torch.distributed`` process group, the counterpart of
the reference's ``jax.distributed.initialize``: rank 0 hosts the
rendezvous store at the coordinator address, the others connect to it.
After it returns, ``launch/mesh.py``'s meshes span the gang.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.replay import PrioritizedReplay, ReplayConfig, ReplayState, Storage
from repro_torch.device import DeviceLike
from repro_torch.optim.collectives import all_reduce_axes


def _handshake_error(coordinator_address: str, process_id: int, num_processes: int,
                     timeout_s: float) -> RuntimeError:
    return RuntimeError(
        f"coordinator handshake failed: process {process_id}/{num_processes} could not "
        f"join the coordinator at {coordinator_address} within {timeout_s:.0f}s — check "
        "that every worker of the gang was actually launched (launch/multiprocess.py "
        "spawns the full set) and that the coordinator host:port is reachable and not "
        "already bound")


def _wait_for_coordinator(coordinator_address: str, process_id: int,
                          num_processes: int, timeout_s: float) -> None:
    """Poll plain TCP connects against the coordinator until it accepts or
    ``timeout_s`` elapses, so that a missing rank 0 surfaces as the
    handshake error, not as the store's own connect failure."""
    host, _, port = coordinator_address.rpartition(":")
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with socket.create_connection((host, int(port)), timeout=1.0):
                return
        except OSError:
            if time.monotonic() >= deadline:
                raise _handshake_error(coordinator_address, process_id, num_processes,
                                       timeout_s) from None
            time.sleep(0.25)


def initialize_distributed(coordinator_address: str, num_processes: int, process_id: int,
                           timeout_s: float = 60.0, *, backend: str) -> None:
    """Join the gang as rank ``process_id`` of ``num_processes``
    (``launch/multiprocess.py``, ``launch/train.py --wall-clock``).

    Ranks other than 0 first probe the coordinator with plain TCP connects
    until ``timeout_s``; then every rank calls ``init_process_group(backend,
    init_method="tcp://host:port")`` with that timeout, which blocks until
    the whole gang has joined.  Any failure is raised as a ``RuntimeError``
    naming the coordinator, never a hang.  The caller picks ``backend``:
    ``"gloo"`` for ranks that share one card (NCCL refuses two ranks on one
    GPU), ``"nccl"`` for a card a rank."""
    if num_processes < 1:
        raise ValueError(f"num_processes={num_processes}: need ≥ 1")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id}: need 0 ≤ id < {num_processes}")
    if process_id != 0:
        _wait_for_coordinator(coordinator_address, process_id, num_processes, timeout_s)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                rank=process_id, world_size=num_processes,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise _handshake_error(coordinator_address, process_id, num_processes,
                               timeout_s) from e


@dataclasses.dataclass(frozen=True)
class ShardedReplayConfig:
    """``axis_names`` may span several mesh axes — e.g. ``("pod",
    "data")`` — and then every global stat reduces over all of them (one
    shard per mesh cell).  Outer/slow axis first: the executor compresses
    gradients across ``axis_names[0]``."""

    capacity_per_shard: int
    fanout: int = 128
    alpha: float = 0.6
    eps: float = 1e-6
    backend: Optional[str] = None           # TreeOps backend (ReplayConfig)
    fused_sample_gather: bool = False
    axis_names: Tuple[str, ...] = ("data",)


class ShardedPrioritizedReplay:
    """This rank's replay shard; ``sample`` reduces over the mesh."""

    def __init__(self, config: ShardedReplayConfig, example_item: Storage,
                 device: DeviceLike = "cuda"):
        if not config.axis_names:
            raise ValueError("axis_names must name at least one mesh axis")
        if len(set(config.axis_names)) != len(config.axis_names):
            raise ValueError(
                f"duplicate mesh axes in axis_names={config.axis_names}: "
                "each axis reduces once in the global stats")
        self.config = config
        self.local = PrioritizedReplay(
            ReplayConfig(capacity=config.capacity_per_shard, fanout=config.fanout,
                         alpha=config.alpha, eps=config.eps, backend=config.backend,
                         fused_sample_gather=config.fused_sample_gather),
            example_item, device=device)
        self.device = self.local.device
        self.spec = self.local.spec
        self.ops = self.local.ops

    def init(self) -> ReplayState:
        return self.local.init()

    # -- global scalars (one all-reduce of 2 floats per axis) ----------------

    def global_stats(self, state: ReplayState, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total priority, item count) summed over the mesh, as f32
        scalars, in ONE stacked all-reduce per axis."""
        count = torch.full((), float(state.count), dtype=torch.float32, device=self.device)
        stats = all_reduce_axes(torch.stack([state.tree[0], count]),
                                self.config.axis_names, mesh, "sum")
        return stats[0], stats[1]

    def max_across(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """Global max over the mesh axes (the weight normalizer over *all*
        shards' draws, not the local batch max)."""
        return all_reduce_axes(x.clone(), self.config.axis_names, mesh, "max")

    # -- shard-local ops (no collective) ----------------------------------------

    def insert(self, state: ReplayState, items: Storage) -> ReplayState:
        return self.local.insert(state, items)

    def append(self, state: ReplayState, items: Storage, *, lazy: bool = True
               ) -> ReplayState:
        return self.local.append(state, items, lazy=lazy)

    def insert_begin(self, state: ReplayState, batch: int, *, lazy: bool = False):
        return self.local.insert_begin(state, batch, lazy=lazy)

    def insert_commit(self, state: ReplayState, slots: torch.Tensor, items: Storage, *,
                      lazy: bool = False) -> ReplayState:
        return self.local.insert_commit(state, slots, items, lazy=lazy)

    def flush(self, state: ReplayState) -> ReplayState:
        return self.local.flush(state)

    def update_priorities(self, state: ReplayState, idx: torch.Tensor,
                          td_errors: torch.Tensor, *, lazy: bool = False) -> ReplayState:
        return self.local.update_priorities(state, idx, td_errors, lazy=lazy)

    # -- sampling -------------------------------------------------------------

    def sample(self, state: ReplayState, generator: Optional[torch.Generator],
               batch_per_shard: int, beta: float = 0.4, *, mesh,
               u: Optional[torch.Tensor] = None):
        """Stratified global sample: ``batch_per_shard`` local draws with
        weights against the global distribution and the global max."""
        g_tot, g_cnt = self.global_stats(state, mesh)
        return self.local.sample(state, generator, batch_per_shard, beta, u=u,
                                 global_total=g_tot, global_count=g_cnt,
                                 max_across=lambda x: self.max_across(x, mesh))
