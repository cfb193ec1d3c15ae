"""Executor layer — port of ``repro.runtime.executors``: the fused
single-device executor, the sharded executor over a mesh of ranks and the
async executor with or without a mesh.

``FusedExecutor`` runs the composed step (runtime/loop.py) in chunks of
``scan_chunk`` iterations: a Python loop takes the place of the
reference's ``lax.scan``.  ``Executor.run`` performs exactly the
requested number of iterations (full chunks plus one tail) and keeps the
last iteration's metrics of each chunk as ``history``; it reads device
values back only when it logs and once at the end.

``executor_from_plan`` builds whichever of these (or the replay
service's ``ServiceExecutor``) a ``runtime/planner.py`` plan selected.

``ShardedExecutor`` is the reference's ``shard_map`` program as one
process a shard: each rank of a ``launch/mesh.py`` mesh constructs it
with the same arguments, runs E/D envs and B/D draws a learner call on
its own replay shard, and reduces gradients (``runtime/learner.py``) and,
once a chunk, the metrics over the mesh.  The agent state is replicated:
rank 0's is broadcast at ``init`` and every rank applies the same reduced
update.

Typical use, on every rank of a process group of 4::

    mesh = data_mesh(4)
    srb = ShardedPrioritizedReplay(ShardedReplayConfig(...), example)
    ex = ShardedExecutor(agent, srb, env_fn, cfg, n_envs=8, mesh=mesh)
    state, history = ex.train(iterations=2000, seed=0)
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.agents.base import Agent, generator_names, state_tensors
from repro_torch.core.distributed import ShardedPrioritizedReplay
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.collectives import all_reduce_axes, broadcast_
from repro_torch.runtime.learner import make_sharded_learn
from repro_torch.runtime.loop import (LoopConfig, LoopState, Metric,
                                      RatioSchedule, init_loop_state, make_step,
                                      publish)

History = Dict[str, torch.Tensor]


def _stack(values: List[Metric]) -> torch.Tensor:
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values).cpu()
    return torch.tensor(values)


class Executor:
    """Common chunked runner; subclasses provide ``init`` and ``step``."""

    schedule: RatioSchedule
    scan_chunk: int
    step: Callable[[LoopState], Tuple[LoopState, Dict[str, Metric]]]

    def init(self, seed: int) -> LoopState:
        raise NotImplementedError

    def run_chunk(self, state: LoopState, length: Optional[int] = None):
        """(state) → (state, metrics of the chunk's last iteration)."""
        length = self.scan_chunk if length is None else length
        metrics = None
        for _ in range(length):
            state, metrics = self.step(state)
        return state, metrics

    def run(self, state: LoopState, iterations: int, log_every: int = 0
            ) -> Tuple[LoopState, History]:
        """Run *exactly* ``iterations`` iterations: full ``scan_chunk``
        chunks plus one exact-length tail.  ``history`` holds the last
        iteration's metrics of each chunk, as CPU tensors."""
        if iterations < 1:
            raise ValueError(f"iterations={iterations}: need ≥ 1")
        history: List[Dict[str, Metric]] = []
        done_iters = 0
        while done_iters < iterations:
            length = min(self.scan_chunk, iterations - done_iters)
            state, last = self.run_chunk(state, length)
            prev_iters, done_iters = done_iters, done_iters + length
            history.append(last)
            if log_every and done_iters // log_every > prev_iters // log_every:
                print(f"iter={done_iters} "
                      f"return={float(last['mean_episode_return']):.1f} "
                      f"loss={float(last['loss']):.4f} "
                      f"buffer={int(last['buffer_size'])} "
                      f"learns={int(last['learn_steps'])}")
        return state, {k: _stack([h[k] for h in history]) for k in history[0]}

    def train(self, iterations: int, seed: int, log_every: int = 0
              ) -> Tuple[LoopState, History]:
        return self.run(self.init(seed), iterations, log_every)


class FusedExecutor(Executor):
    """All actors, the buffer and the learners in one process on one
    device (the paper's single-node regime).  Runs on CUDA unless
    ``device="cpu"``; the replay must live on the same device.
    ``publish_interval`` is the async executor's plumbing: > 0 acts on
    the delayed copy (``AsyncExecutor``), 0 is the synchronous loop;
    ``external_publish`` leaves the copy's republish to the wall-clock
    gang (``make_step``)."""

    def __init__(
        self,
        agent: Agent,
        replay: PrioritizedReplay,
        env_fn: Callable[[int], tuple],
        cfg: LoopConfig,
        n_envs: int,
        scan_chunk: int = 64,
        device: DeviceLike = "cuda",
        publish_interval: int = 0,
        external_publish: bool = False,
    ):
        self.device = resolve_device(device)
        if replay.device != self.device:
            raise ValueError(f"replay lives on {replay.device}, the executor "
                             f"runs on {self.device}")
        self.agent = agent
        self.replay = replay
        self.cfg = cfg
        self.n_envs = n_envs
        self.scan_chunk = scan_chunk
        self.publish_interval = publish_interval
        self.spec, self._v_reset, self._v_step = env_fn(n_envs)
        self.schedule = RatioSchedule.from_config(cfg, n_envs)
        self.step = make_step(agent, replay, self._v_step, cfg, n_envs,
                              schedule=self.schedule,
                              publish_interval=publish_interval,
                              external_publish=external_publish)

    def init(self, seed: int) -> LoopState:
        return init_loop_state(self.agent, self.replay, self._v_reset, seed,
                               self.n_envs, double_buffer=self.publish_interval > 0)


class ShardedExecutor(Executor):
    """One rank of the sharded program: this shard's actors and replay
    shard, learners whose gradients reduce over the mesh.

    ``n_envs`` is the *global* env count; each of the D shards (D = the
    product of the replay config's axis extents: a 2×2 pod×data mesh has
    D = 4) runs ``n_envs / D`` envs and draws ``cfg.batch_size / D`` items
    a learner call (the global batch is kept under the gradient mean).
    Shard identity is the flattened row-major (pod, data) index, the rank,
    so a 2×1 pod×data mesh reproduces a 1-D 2-shard mesh exactly.

    ``compress_pod_reduce=True`` (2-D meshes; the first axis is the slow
    one) reduces across pods with the int8 error-feedback mean, its buffer
    in ``LoopState.ef_error``; ``overlap_pod_reduce=True`` double-buffers
    that leg (``make_grad_reducer(overlap=True)``).  ``publish_interval``
    and ``max_staleness`` are ``AsyncExecutor``'s plumbing: each shard
    acts on its own delayed copy, published on staggered ticks, and the
    reduce weights each shard by the age of its copy; ``external_publish``
    leaves the republish to the wall-clock gang (``make_step``).

    Each rank holds its own replay shard, acting copy and EF buffer; the
    agent state is replicated (rank 0's, broadcast by ``init``) — with
    ``overlap_pod_reduce`` within a pod, since each pod applies its own
    partial's delta to the shared cross-pod mean (``make_grad_reducer``)."""

    def __init__(
        self,
        agent: Agent,
        replay: ShardedPrioritizedReplay,
        env_fn: Callable[[int], tuple],
        cfg: LoopConfig,
        n_envs: int,
        mesh,
        scan_chunk: int = 64,
        publish_interval: int = 0,
        max_staleness: Optional[int] = None,
        compress_pod_reduce: bool = False,
        intra_pod_dtype: Optional[str] = None,
        overlap_pod_reduce: bool = False,
        device: DeviceLike = "cuda",
        external_publish: bool = False,
    ):
        axes = tuple(replay.config.axis_names)
        missing = [ax for ax in axes if ax not in mesh.shape]
        if missing:
            raise ValueError(f"replay axes {missing} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        extra = [ax for ax in mesh.shape if ax not in axes]
        if extra:
            raise ValueError(
                f"mesh axes {extra} are not in the replay config's "
                f"axis_names {axes}: the executor would replicate every "
                "shard across them (duplicate programs on "
                f"{math.prod(mesh.shape[ax] for ax in extra)}× the "
                "devices, no extra capacity or gradient averaging) — "
                "name every mesh axis in ShardedReplayConfig.axis_names, "
                "e.g. axis_names=(\"pod\", \"data\") for pod_data_mesh")
        if compress_pod_reduce and len(axes) < 2:
            raise ValueError(
                "compress_pod_reduce needs a multi-axis (pod, data) mesh: "
                f"with the single axis {axes} there is no slow cross-pod "
                "link to compress — the intra-pod reduce stays f32")
        if overlap_pod_reduce and not compress_pod_reduce:
            raise ValueError(
                "overlap_pod_reduce needs compress_pod_reduce=True: the "
                "double buffer defers the *compressed* cross-pod leg — "
                "there is no overlapped form of the plain global pmean")
        if overlap_pod_reduce and publish_interval and max_staleness is not None:
            raise ValueError(
                "overlap_pod_reduce is incompatible with max_staleness: "
                "the bounded-staleness reduce renormalizes by a global "
                "weight total, which puts this event's cross-pod traffic "
                "back on the critical path (runtime/learner.py)")
        n_shards = math.prod(mesh.shape[ax] for ax in axes)
        if n_envs % n_shards:
            raise ValueError(f"n_envs={n_envs} not divisible by "
                             f"{n_shards} shards")
        if cfg.batch_size % n_shards:
            raise ValueError(f"batch_size={cfg.batch_size} not divisible by "
                             f"{n_shards} shards")
        self.device = resolve_device(device)
        if replay.device != self.device:
            raise ValueError(f"replay lives on {replay.device}, the executor "
                             f"runs on {self.device}")
        self._axes = axes
        self.agent = agent
        self.replay = replay
        self.cfg = cfg
        self.mesh = mesh
        self.n_shards = n_shards
        self.n_envs = n_envs
        self.n_envs_local = n_envs // n_shards
        self.scan_chunk = scan_chunk
        self.publish_interval = publish_interval
        self.compress_pod_reduce = compress_pod_reduce
        self.overlap_pod_reduce = overlap_pod_reduce
        self.spec, self._v_reset, self._v_step = env_fn(self.n_envs_local)
        self.schedule = RatioSchedule.from_config(cfg, n_envs)

        if publish_interval and max_staleness is not None:
            # shard d's staggered publish clock has phase d mod P, so at
            # learn ticks (every `period` iterations) its age cycles over
            # {(d + k·gcd(P, period)) mod P}, whose minimum is d mod gcd: a
            # shard whose minimum exceeds the bound would be dropped from
            # EVERY reduce and its replay data would never train
            g = math.gcd(publish_interval, self.schedule.period)
            if min(g, n_shards) > max_staleness + 1:
                raise ValueError(
                    f"publish_interval={publish_interval} and the learn "
                    f"period {self.schedule.period} share the factor {g} > "
                    f"max_staleness+1={max_staleness + 1}: shards whose "
                    "staggered publish phase exceeds the staleness bound at "
                    "every learn tick would be permanently dropped from the "
                    "gradient reduce (their replay data would never train). "
                    "Pick a publish_interval coprime with the learn period "
                    "or raise max_staleness.")

        learn_fn = make_sharded_learn(
            agent, replay, batch_per_shard=cfg.batch_size // n_shards, mesh=mesh,
            beta=cfg.beta,
            max_staleness=max_staleness if publish_interval else None,
            compress_axis=axes[0] if compress_pod_reduce else None,
            intra_pod_dtype=intra_pod_dtype, lazy_writes=cfg.lazy_replay,
            overlap=overlap_pod_reduce)
        # the step's metrics stay shard-local: run_chunk reduces the chunk's
        # last metrics over the mesh in one collective
        self.step = make_step(agent, replay, self._v_step, cfg, self.n_envs_local,
                              schedule=self.schedule, learn_fn=learn_fn,
                              shard_id=mesh.shard_id, publish_interval=publish_interval,
                              external_publish=external_publish)

    def init(self, seed: int) -> LoopState:
        """This shard's initial state (``loop.init_loop_state`` with its
        shard id), with rank 0's agent state broadcast to every rank, and
        the acting copy taken after that.  The learn generators of TD3 and
        SAC are not broadcast: every rank seeds them with the same
        constant."""
        st = init_loop_state(self.agent, self.replay, self._v_reset, seed,
                             self.n_envs_local, double_buffer=self.publish_interval > 0,
                             shard_id=self.mesh.shard_id,
                             ef_buffer=self.compress_pod_reduce,
                             overlap=self.overlap_pod_reduce)
        gens = generator_names(st.agent)
        broadcast_([t for k, t in state_tensors(st.agent).items() if k not in gens])
        if st.actor_params is not None:
            publish(st.actor_params, self.agent.params_for_acting(st.agent))
        return st

    def _reduce_metrics(self, metrics: Dict[str, Metric]) -> Dict[str, Metric]:
        """Reduce the shard-local metrics over the mesh in ONE collective
        per axis: loss, return and error norm as means, ``buffer_size`` as
        the mean × D, rounded (counts are exact in f32; the round clears
        the /D·D rounding when D is not a power of two)."""
        def dev(x):
            return (x if isinstance(x, torch.Tensor) else
                    torch.full((), float(x), dtype=torch.float32, device=self.device))
        stack = torch.stack([dev(metrics["loss"]), dev(metrics["mean_episode_return"]),
                             dev(metrics["compress_error_norm"]),
                             dev(metrics["buffer_size"])])
        stack = all_reduce_axes(stack, self._axes, self.mesh, "mean")
        out = dict(metrics)
        out["loss"] = stack[0]
        out["mean_episode_return"] = stack[1]
        out["compress_error_norm"] = stack[2]
        out["buffer_size"] = torch.round(stack[3] * self.n_shards).to(torch.int64)
        return out

    def run_chunk(self, state: LoopState, length: Optional[int] = None):
        state, metrics = super().run_chunk(state, length)
        return state, self._reduce_metrics(metrics)


class AsyncExecutor(Executor):
    """Bounded-staleness backend: decoupled actor and learner parameter
    clocks.  Actors act on a delayed copy of the online module
    (``LoopState.actor_params``), republished from the fresh learner
    params every ``publish_interval`` iterations; learners update the
    fresh params at every scheduled learn event.

    Without ``mesh`` this is the fused program with the double buffer
    (``max_staleness`` has no reduce to weight there); at
    ``publish_interval=1`` the copy is republished after every iteration
    and the run is ``FusedExecutor``'s bit for bit from the same seed.
    With ``mesh`` it is this rank's ``ShardedExecutor`` with staggered
    publish ticks, so shards act at different ages, and each shard's
    gradient enters the reduce weighted by ``staleness_weights(age,
    max_staleness)``, renormalized: a shard past the bound is dropped and
    the survivors' weights sum to 1 (``runtime/learner.py``).
    """

    def __init__(
        self,
        agent: Agent,
        replay,
        env_fn: Callable[[int], tuple],
        cfg: LoopConfig,
        n_envs: int,
        publish_interval: int = 1,
        scan_chunk: int = 64,
        device: DeviceLike = "cuda",
        max_staleness: int = 0,
        mesh=None,
        compress_pod_reduce: bool = False,
        intra_pod_dtype: Optional[str] = None,
        overlap_pod_reduce: bool = False,
    ):
        if publish_interval < 1:
            raise ValueError(
                f"publish_interval={publish_interval}: need ≥ 1 (1 = "
                "republish every iteration = the synchronous loop)")
        if max_staleness < 0:
            raise ValueError(f"max_staleness={max_staleness}: need ≥ 0")
        if overlap_pod_reduce and max_staleness:
            raise ValueError(
                "overlap_pod_reduce is incompatible with max_staleness > "
                "0: the bounded-staleness reduce renormalizes by a global "
                "weight total, putting this event's cross-pod traffic "
                "back on the critical path (runtime/learner.py)")
        if mesh is None:
            if compress_pod_reduce:
                raise ValueError(
                    "compress_pod_reduce needs a (pod, data) mesh — the "
                    "fused path has no cross-pod reduce to compress")
            if overlap_pod_reduce:
                raise ValueError(
                    "overlap_pod_reduce needs a (pod, data) mesh — the "
                    "fused path has no cross-pod reduce to overlap")
            if intra_pod_dtype not in (None, "f32", "float32"):
                raise ValueError(
                    "intra_pod_dtype needs a mesh — the fused path has "
                    "no cross-shard reduce to cast")
            self._impl: Executor = FusedExecutor(
                agent, replay, env_fn, cfg, n_envs, scan_chunk=scan_chunk, device=device,
                publish_interval=publish_interval)
        else:
            self._impl = ShardedExecutor(
                agent, replay, env_fn, cfg, n_envs, mesh, scan_chunk=scan_chunk,
                publish_interval=publish_interval,
                max_staleness=None if overlap_pod_reduce else max_staleness,
                compress_pod_reduce=compress_pod_reduce,
                intra_pod_dtype=intra_pod_dtype,
                overlap_pod_reduce=overlap_pod_reduce, device=device)
            self.n_shards = self._impl.n_shards
            self.n_envs_local = self._impl.n_envs_local
        self.agent = agent
        self.replay = replay
        self.cfg = cfg
        self.mesh = mesh
        self.n_envs = n_envs
        self.scan_chunk = scan_chunk
        self.publish_interval = publish_interval
        self.device = self._impl.device
        self.spec = self._impl.spec
        self._v_reset = self._impl._v_reset
        self.step = self._impl.step
        self.schedule = self._impl.schedule

    def init(self, seed: int) -> LoopState:
        return self._impl.init(seed)

    def run_chunk(self, state: LoopState, length: Optional[int] = None):
        return self._impl.run_chunk(state, length)


def executor_from_plan(
    plan,
    agent: Agent,
    env_fn: Callable[[int], tuple],
    cfg: LoopConfig,
    example,
    *,
    capacity: int = 50_000,
    fanout: int = 128,
    tree_backend: Optional[str] = None,
    scan_chunk: int = 64,
    intra_pod_dtype: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Executor:
    """Instantiate the executor a ``runtime.planner.PlannedConfig``
    selected: the backend class, the mesh (``launch.mesh.mesh_from_plan``),
    the replay and the async knobs, with the plan's ``n_envs`` and
    ``update_interval`` applied (the latter overrides
    ``cfg.update_interval``: the plan *is* the Eq. 5 answer for the ratio
    it was solved at).  ``tree_backend`` is the replay's TreeOps backend
    (``None``: by device).

    A plan with a mesh is built on each rank of a process group of
    ``plan.n_devices`` ranks (``launch/mesh.py::spawn``;
    ``python -m repro_torch.quickstart --plan`` shows it).  A plan with
    ``n_replay_shards ≥ 1`` routes experience through an in-process
    ``ReplayService`` (round-robin router) behind a ``RateLimiter`` at the
    plan's ``samples_per_insert``: the ``ServiceExecutor`` form of the same
    workload, which runs the fused program; a mesh together with a service
    is refused (``launch_service`` runs the multi-process service gang)."""
    import dataclasses

    from repro_torch.core.distributed import ShardedReplayConfig
    from repro_torch.core.replay import ReplayConfig
    from repro_torch.launch.mesh import mesh_from_plan

    cfg = dataclasses.replace(cfg, update_interval=plan.update_interval)
    if plan.n_replay_shards:
        from repro_torch.service.executor import ServiceExecutor
        from repro_torch.service.rate_limiter import RateLimiter
        from repro_torch.service.server import ReplayService, ReplayServiceConfig

        if plan.n_data:
            raise ValueError(
                f"plan ({plan.describe()}) combines a device mesh with a "
                "replay service — the service executor runs the fused "
                "per-process program; use launch_service for a gang")
        service = ReplayService(
            ReplayServiceConfig(capacity_per_shard=max(1, capacity // plan.n_replay_shards),
                                n_shards=plan.n_replay_shards, fanout=fanout,
                                backend=tree_backend, router="round_robin"),
            example, device=device)
        limiter = None
        if plan.samples_per_insert:
            limiter = RateLimiter.for_loop(
                cfg.batch_size, max(1, round(cfg.batch_size / plan.samples_per_insert)),
                cfg.warmup, insert_burst=plan.n_envs)
        return ServiceExecutor(agent, service, env_fn, cfg, plan.n_envs,
                               scan_chunk=scan_chunk, rate_limiter=limiter)
    mesh = mesh_from_plan(plan)
    if mesh is None:
        if intra_pod_dtype not in (None, "f32", "float32"):
            raise ValueError(
                f"intra_pod_dtype={intra_pod_dtype!r} but the plan "
                f"({plan.describe()}) runs the fused program — there is "
                "no cross-shard reduce to cast")
        replay = PrioritizedReplay(ReplayConfig(capacity=capacity, fanout=fanout,
                                                backend=tree_backend), example, device=device)
        if plan.backend == "async":
            return AsyncExecutor(agent, replay, env_fn, cfg, plan.n_envs,
                                 publish_interval=plan.publish_interval,
                                 max_staleness=plan.max_staleness,
                                 scan_chunk=scan_chunk, device=device)
        return FusedExecutor(agent, replay, env_fn, cfg, plan.n_envs,
                             scan_chunk=scan_chunk, device=device)
    axis_names = ("pod", "data") if plan.n_pods > 1 else ("data",)
    replay = ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=capacity // plan.n_shards, fanout=fanout,
                            backend=tree_backend, axis_names=axis_names),
        example, device=device)
    if plan.backend == "async":
        return AsyncExecutor(agent, replay, env_fn, cfg, plan.n_envs,
                             publish_interval=plan.publish_interval,
                             max_staleness=plan.max_staleness, mesh=mesh,
                             scan_chunk=scan_chunk,
                             compress_pod_reduce=plan.compress_pod_reduce,
                             intra_pod_dtype=intra_pod_dtype,
                             overlap_pod_reduce=plan.overlap_pod_reduce, device=device)
    return ShardedExecutor(agent, replay, env_fn, cfg, plan.n_envs, mesh,
                           scan_chunk=scan_chunk,
                           compress_pod_reduce=plan.compress_pod_reduce,
                           intra_pod_dtype=intra_pod_dtype,
                           overlap_pod_reduce=plan.overlap_pod_reduce, device=device)
