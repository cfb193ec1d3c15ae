"""The paper's training loop (Alg. 1) as composable actor/learner programs
— port of ``repro.runtime.loop``: the synchronous loop, the async loop in
which actors act on a delayed parameter copy, the same step run by each
rank of a mesh (``runtime/executors.py::ShardedExecutor``), and the split
actor and learner programs that meet at the replay service
(``service/``).

One iteration, in the reference's phase order:

    1. ACTORS       — ε-greedy act on E batched envs, env step
    2. INSERT-BEGIN — zero the in-flight slots' leaf priorities
    3. FLUSH        — ONE rebuild pass (lazy ≡ eager bit-exact here)
    4. LEARNERS     — sample B from the flushed tree, TD update, priority
                      write-back (a flush between extra learner calls)
    5. INSERT-COMMIT — storage write + P_max restore

With ``LoopConfig.lazy_replay`` (the default) steps 2, 4's write-back and
5 write only the leaf level, so an iteration runs one propagation pass.

The reference decides whether to learn with ``lax.cond`` on device
counters.  Here the iteration clock (``env_steps``, ``learn_steps``) is
a host int, because it depends only on the iteration count: the gate is
decided on the host, and a step reads nothing back from the device (no
``.item()``, no ``bool(tensor)``), which keeps the step capturable as a
CUDA graph later.  The metrics that depend on data (loss, return) stay
device tensors.

With ``publish_interval=P ≥ 1`` the actors act on
``LoopState.actor_params``, a copy of the online module made once by
``init_loop_state(double_buffer=True)``, while the learners keep
updating ``LoopState.agent``: the paper's actors that never block on the
learners (§IV-D).  At the end of iteration ``it`` the copy is republished
iff ``(it + 1 + d) % P == 0`` on shard ``d`` (0 without a mesh; the
stagger gives the shards different ages): the fresh module's tensors are
copied into the copy's own tensors in place, never rebound, so the copy
never aliases the learners' module.  ``params_age`` counts iterations
since the last publish and is handed to the learn fn (the sharded reduce
weights a shard by it); like the publish tick it depends only on the
iteration count, so both are host ints.  ``P = 1`` republishes every
iteration and is the synchronous loop bit for bit.  With
``external_publish`` the step only ages the copy: the wall-clock gang
(``launch/multiprocess.py``) republishes it between chunks through the
host.

On a mesh each rank runs this step on its own envs and replay shard, with
``learn_fn`` the sharded learner (``runtime/learner.py``), which reduces
over the mesh; ``LoopState.ef_error`` carries the error-feedback buffer
of the compressed cross-pod reduce.  Seeding (``init_loop_state``): shard
0 draws from the generator seeded with ``seed`` itself, so one shard is
the fused loop bit for bit; shard ``d > 0`` from ``shard_seed(seed, d)``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.agents.base import Agent, AgentState
from repro_torch.core.replay import PrioritizedReplay, ReplayState
from repro_torch.optim import compress

Metric = Union[torch.Tensor, int, float]

# keys of the metrics dict every composed step returns
METRIC_KEYS = ("loss", "mean_episode_return", "env_steps", "learn_steps",
               "buffer_size", "epsilon", "compress_error_norm")

# keys of the metrics dict every learn fn returns (make_learner_step and
# runtime/learner.make_sharded_learn)
LEARN_METRIC_KEYS = ("loss", "compress_error_norm")


class LoopState(NamedTuple):
    agent: AgentState
    replay: ReplayState
    env_state: object
    obs: torch.Tensor
    rng: torch.Generator
    env_steps: int
    episode_return: torch.Tensor   # running per-env return accumulator
    last_return: torch.Tensor      # most recently finished episode returns
    learn_steps: int               # cumulative learner update count
    # async double buffer (None and 0 on the synchronous loop):
    actor_params: Optional[nn.Module] = None   # delayed acting copy
    params_age: int = 0            # iterations since the last publish
    # error-feedback buffer of the int8 cross-pod reduce (a list of f32
    # tensors shaped like the params, or with overlap the dict {"ef",
    # "prev_mean", "prev_partial"} of such lists); None when uncompressed
    ef_error: Any = None


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    batch_size: int = 128
    update_interval: int = 1      # env steps per learn step (paper ratio)
    learns_per_step: int = 1      # extra learner calls per learn event
    warmup: int = 1000            # env steps before learning starts
    epsilon: float = 0.1          # exploration at step 0
    epsilon_final: float = 0.02   # exploration floor after decay
    epsilon_decay_steps: int = 10_000   # env steps of linear ε decay
    beta: float = 0.4             # PER importance exponent
    lazy_replay: bool = True      # one merged propagation pass per iteration


@dataclasses.dataclass(frozen=True)
class RatioSchedule:
    """Static actor/learner interleave realizing ``update_interval``:
    ``period`` iterations between learn events, ``learns`` learner calls
    per event."""

    period: int
    learns: int
    env_steps_per_iter: int

    @property
    def realized_ratio(self) -> float:
        return self.period * self.env_steps_per_iter / self.learns

    @classmethod
    def from_config(cls, cfg: LoopConfig, env_steps_per_iter: int) -> "RatioSchedule":
        u = max(1, cfg.update_interval)
        e = env_steps_per_iter
        if u >= e:
            return cls(period=max(1, round(u / e)),
                       learns=max(1, cfg.learns_per_step),
                       env_steps_per_iter=e)
        return cls(period=1,
                   learns=max(1, round(e / u)) * max(1, cfg.learns_per_step),
                   env_steps_per_iter=e)


def epsilon_schedule(cfg: LoopConfig, env_steps: int) -> float:
    """Linear ε decay: cfg.epsilon → cfg.epsilon_final over decay_steps."""
    frac = min(max(env_steps / max(1, cfg.epsilon_decay_steps), 0.0), 1.0)
    return cfg.epsilon + (cfg.epsilon_final - cfg.epsilon) * frac


# -- actor program -----------------------------------------------------------


def make_actor_step(agent: Agent, v_step: Callable, n_envs: int):
    """One parallel-actor interaction: act on E envs, step, package the
    transition batch."""

    def actor_step(agent_state, env_state, obs, ep_ret, last_ret,
                   gen: torch.Generator, epsilon: float):
        actions = agent.act(agent_state, obs, gen, epsilon)
        env_state, obs_next, rew, done, true_next = v_step(env_state, actions, gen)
        ep_ret = ep_ret + rew
        last_ret = torch.where(done, ep_ret, last_ret)
        ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
        transitions = {
            "obs": obs,
            "action": actions,
            "reward": rew,
            "next_obs": true_next,
            "done": done.to(torch.float32),
        }
        return env_state, obs_next, ep_ret, last_ret, transitions

    return actor_step


# -- actor-side program (service boundary, DESIGN.md §11) --------------------


class ActorSlice(NamedTuple):
    """The actor-side state of the decoupled runtime: everything an actor
    process owns when the replay buffer lives behind a service — env state
    and the episode-return bookkeeping.  The agent params arrive through
    the service's params channel; the replay state never enters the
    actor's process."""

    env_state: object
    obs: torch.Tensor
    episode_return: torch.Tensor
    last_return: torch.Tensor


def init_actor_slice(v_reset: Callable, gen: torch.Generator, n_envs: int) -> ActorSlice:
    """Fresh envs from ``gen`` (the reference folds the actor's id into
    its key; here the caller seeds each actor's generator apart), on the
    generator's device."""
    env_state, obs = v_reset(gen)
    zeros = torch.zeros((n_envs,), dtype=torch.float32, device=obs.device)
    return ActorSlice(env_state=env_state, obs=obs, episode_return=zeros,
                      last_return=zeros.clone())


def make_actor_program(agent: Agent, v_step: Callable, cfg: LoopConfig, n_envs: int):
    """The actor side of the split runtime: (acting params, env slice,
    generator, global env-step clock) → a transition batch, with no replay
    state and no learner.  The ε-schedule is computed from the host-int
    ``env_steps`` clock (the service reports its global inserts), so the
    fleet's exploration decays as one actor's would.

    Returns ``program(agent_state, slice, gen, env_steps) → (slice',
    transitions)``; the caller owns the generator and the append."""
    actor_step = make_actor_step(agent, v_step, n_envs)

    def program(agent_state, sl: ActorSlice, gen: torch.Generator, env_steps: int):
        eps = epsilon_schedule(cfg, env_steps)
        env_state, obs, ep_ret, last_ret, transitions = actor_step(
            agent_state, sl.env_state, sl.obs, sl.episode_return, sl.last_return,
            gen, eps)
        return ActorSlice(env_state, obs, ep_ret, last_ret), transitions

    return program


# -- learner program ---------------------------------------------------------


def make_learner_program(agent: Agent):
    """The learner side of the split runtime (DESIGN.md §11): learn on a
    batch handed over the service boundary and return the TD errors that
    the service writes back as priorities.  Sample and priority update
    live behind the service; ``make_learner_step`` below is this program
    composed with an in-process replay.

    Returns ``program(agent_state, items, weights) → (agent_state,
    metrics, |td|)``."""

    def program(agent_state, items, weights):
        return agent.learn(agent_state, items, weights)

    return program


def make_learner_step(agent: Agent, replay: PrioritizedReplay, cfg: LoopConfig):
    """One parallel-learner call: PER sample → TD update → priority
    write-back (leaf-only with ``cfg.lazy_replay``, riding the next
    flush).  ``u`` overrides the sample's uniform draws.  ``age`` and
    ``ef`` belong to the learn-fn signature that the sharded learner
    shares; here they pass through unused, and the error norm is 0.0."""

    def learner_step(agent_state, replay_state, gen, u=None, age=None, ef=None):
        del age  # no cross-shard reduce to weight
        idx, items, is_w = replay.sample(replay_state, gen, cfg.batch_size,
                                         cfg.beta, u=u)
        agent_state, metrics, td = agent.learn(agent_state, items, is_w)
        replay_state = replay.update_priorities(replay_state, idx, td,
                                                lazy=cfg.lazy_replay)
        return (agent_state, replay_state,
                {"loss": metrics["loss"], "compress_error_norm": 0.0}, ef)

    return learner_step


# -- composed step -----------------------------------------------------------


@torch.no_grad()
def publish(held: nn.Module, fresh: nn.Module) -> None:
    """Copy the fresh module's tensors into the acting copy's, in place."""
    torch._foreach_copy_(list(held.parameters()), list(fresh.parameters()))


def make_step(agent: Agent, replay, v_step: Callable, cfg: LoopConfig,
              n_envs: int, *, schedule: Optional[RatioSchedule] = None,
              learn_fn: Optional[Callable] = None, shard_id: int = 0,
              publish_interval: int = 0, external_publish: bool = False):
    """Compose actor + learner programs into one ``step(state) → (state,
    metrics)``.

    ``n_envs`` is this shard's env count; ``schedule`` carries the global
    env steps per iteration.  ``learn_fn`` replaces the fused learner
    (the sharded one reduces over a mesh) and ``shard_id`` staggers the
    publish tick.  Metrics are this shard's; the sharded executor reduces
    them over the mesh once a chunk.

    ``publish_interval=0`` is the synchronous loop: actors act on the
    fresh ``state.agent``.  ``publish_interval=P ≥ 1`` is the async loop
    (module docstring); its state needs
    ``init_loop_state(double_buffer=True)``.

    ``external_publish=True`` (the wall-clock gang) keeps the async
    acting-copy reads but drops the in-step republish: the host owns the
    publish, a real device→host→device copy of the fresh params between
    chunks that rewrites ``actor_params`` and zeroes ``params_age``
    (``launch/multiprocess.py::_publish_host_roundtrip``).  ``params_age``
    then counts up every iteration, so the staleness-weighted reduce still
    sees honest ages between host publishes."""
    if publish_interval < 0:
        raise ValueError(f"publish_interval={publish_interval}: need ≥ 0 "
                         "(0 = the synchronous loop)")
    if external_publish and not publish_interval:
        raise ValueError(
            "external_publish=True needs publish_interval ≥ 1: the host "
            "publish rewrites the async acting copy, which only exists "
            "on the double-buffered (publish_interval > 0) loop")
    schedule = schedule or RatioSchedule.from_config(cfg, n_envs)
    actor_step = make_actor_step(agent, v_step, n_envs)
    learn_fn = learn_fn or make_learner_step(agent, replay, cfg)

    def step(state: LoopState) -> Tuple[LoopState, Dict[str, Metric]]:
        gen = state.rng
        if publish_interval and state.actor_params is None:
            raise ValueError("publish_interval > 0 needs the acting copy: "
                             "init_loop_state(..., double_buffer=True)")
        # 1. parallel actors: on the delayed copy when async, on the fresh
        #    learner params when synchronous
        acting = (agent.with_acting_params(state.agent, state.actor_params)
                  if publish_interval else state.agent)
        eps = epsilon_schedule(cfg, state.env_steps)
        env_state, obs_next, ep_ret, last_ret, transitions = actor_step(
            acting, state.env_state, state.obs,
            state.episode_return, state.last_return, gen, eps)

        # 2. lazy write, phase 1: zero the in-flight slots' leaves
        lazy = cfg.lazy_replay
        replay_state, slots = replay.insert_begin(state.replay, n_envs, lazy=lazy)

        # 3. THE flush boundary: one merged propagation pass
        if lazy:
            replay_state = replay.flush(replay_state)

        # 4. parallel learners on the flushed tree, at the scheduled ratio;
        #    the gate reads only the host clock
        it = state.env_steps // schedule.env_steps_per_iter
        can_learn = state.env_steps >= cfg.warmup and it % schedule.period == 0
        agent_state, learn_steps = state.agent, state.learn_steps
        age = state.params_age if publish_interval else 0
        ef_error = state.ef_error
        loss = torch.zeros((), device=ep_ret.device)
        err_norm = 0.0
        if can_learn:
            for i in range(schedule.learns):
                if lazy and i:
                    # extra learner calls must sample a consistent tree
                    replay_state = replay.flush(replay_state)
                agent_state, replay_state, lmetrics, ef_error = learn_fn(
                    agent_state, replay_state, gen, age=age, ef=ef_error)
                loss = loss + lmetrics["loss"]
                err_norm = err_norm + lmetrics["compress_error_norm"]
            loss = loss / schedule.learns
            err_norm = err_norm / schedule.learns
            learn_steps += schedule.learns

        # 5. lazy write, phase 2: storage write + P_max restore
        replay_state = replay.insert_commit(replay_state, slots, transitions,
                                            lazy=lazy)

        # 6. async publish, on the host's iteration clock, staggered by shard
        #    — unless the host runtime owns the publish (the age counts on)
        params_age = state.params_age
        if publish_interval and external_publish:
            params_age += 1
        elif publish_interval and (it + 1 + shard_id) % publish_interval == 0:
            publish(state.actor_params, agent.params_for_acting(agent_state))
            params_age = 0
        elif publish_interval:
            params_age += 1

        new_state = LoopState(
            agent=agent_state, replay=replay_state, env_state=env_state,
            obs=obs_next, rng=gen,
            env_steps=state.env_steps + schedule.env_steps_per_iter,
            episode_return=ep_ret, last_return=last_ret,
            learn_steps=learn_steps, actor_params=state.actor_params,
            params_age=params_age, ef_error=ef_error)
        metrics = {
            "loss": loss,
            "mean_episode_return": torch.mean(last_ret),
            "env_steps": new_state.env_steps,
            "learn_steps": learn_steps,
            "buffer_size": replay_state.count,
            "epsilon": eps,
            "compress_error_norm": err_norm,
        }
        return new_state, metrics

    return step


def shard_seed(seed: int, shard_id: int) -> int:
    """The generator seed of shard ``shard_id``: ``seed`` itself for shard
    0 (so one shard is the fused loop), else 64 bits of numpy's
    ``SeedSequence((seed, shard_id))``."""
    if shard_id == 0:
        return seed
    return int(np.random.SeedSequence((seed, shard_id)).generate_state(1, np.uint64)[0])


def make_parallel_step(agent: Agent, replay, v_step: Callable, cfg: LoopConfig,
                       n_envs: int):
    """``parallel_step(state) → (state, metrics)``: the fused single-device
    composition — the reference's compat wrapper over ``make_step``."""
    return make_step(agent, replay, v_step, cfg, n_envs)


def init_loop_state(agent: Agent, replay, v_reset: Callable, seed: int, n_envs: int,
                    double_buffer: bool = False, shard_id: int = 0,
                    ef_buffer: bool = False, overlap: bool = False) -> LoopState:
    """Initial state on the replay's device; one generator seeded with
    ``shard_seed(seed, shard_id)`` draws the env resets, the agent init
    and then the loop's random numbers.  ``double_buffer`` fills the async
    acting copy: a deep copy of ``agent.params_for_acting`` at age 0.
    ``ef_buffer`` fills the zero error-feedback buffer of the compressed
    reduce, shaped like the params (the gradient list of agents with the
    grads/apply_grads split); ``overlap`` widens it to the overlapped
    reduce's ``{"ef", "prev_mean", "prev_partial"}``, all zero.  On a mesh
    the executor then makes the agent state every rank's (a broadcast
    from rank 0)."""
    gen = torch.Generator(device=replay.device)
    gen.manual_seed(shard_seed(seed, shard_id))
    env_state, obs = v_reset(gen)
    agent_state = agent.init(gen)
    zeros = torch.zeros((n_envs,), dtype=torch.float32, device=replay.device)
    ef_error = None
    if ef_buffer:
        params = list(agent_state.params.parameters())
        ef_error = ({k: compress.init_error(params)
                     for k in ("ef", "prev_mean", "prev_partial")}
                    if overlap else compress.init_error(params))
    return LoopState(agent=agent_state, replay=replay.init(),
                     env_state=env_state, obs=obs, rng=gen, env_steps=0,
                     episode_return=zeros, last_return=zeros.clone(),
                     learn_steps=0,
                     actor_params=(copy.deepcopy(agent.params_for_acting(agent_state))
                                   .requires_grad_(False) if double_buffer else None),
                     ef_error=ef_error)


def train(agent: Agent, replay: PrioritizedReplay, v_reset: Callable,
          v_step: Callable, cfg: LoopConfig, n_envs: int, iterations: int,
          seed: int, log_every: int = 0, scan_chunk: int = 64):
    """Run the fused loop — a thin wrapper over ``FusedExecutor`` for
    callers that hold (v_reset, v_step) instead of an env factory."""
    from repro_torch.runtime.executors import FusedExecutor  # lazy: avoid cycle

    ex = FusedExecutor(agent, replay, lambda _n: (None, v_reset, v_step),
                       cfg, n_envs, scan_chunk=scan_chunk, device=replay.device)
    return ex.train(iterations, seed, log_every)
