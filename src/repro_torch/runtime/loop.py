"""The paper's training loop (Alg. 1) as composable actor/learner programs
— port of ``repro.runtime.loop`` (synchronous loop only).

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.agents.base import Agent, AgentState
from repro_torch.core.replay import PrioritizedReplay, ReplayState

Metric = Union[torch.Tensor, int, float]

# keys of the metrics dict every composed step returns
METRIC_KEYS = ("loss", "mean_episode_return", "env_steps", "learn_steps",
               "buffer_size", "epsilon")


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


# -- learner program ---------------------------------------------------------


def make_learner_step(agent: Agent, replay: PrioritizedReplay, cfg: LoopConfig):
    """One parallel-learner call: PER sample → TD update → priority
    write-back (leaf-only with ``cfg.lazy_replay``, riding the next
    flush).  ``u`` overrides the sample's uniform draws."""

    def learner_step(agent_state, replay_state, gen, u=None):
        idx, items, is_w = replay.sample(replay_state, gen, cfg.batch_size,
                                         cfg.beta, u=u)
        agent_state, metrics, td = agent.learn(agent_state, items, is_w)
        replay_state = replay.update_priorities(replay_state, idx, td,
                                                lazy=cfg.lazy_replay)
        return agent_state, replay_state, {"loss": metrics["loss"]}

    return learner_step


# -- composed step -----------------------------------------------------------


def make_step(agent: Agent, replay: PrioritizedReplay, v_step: Callable,
              cfg: LoopConfig, n_envs: int, *,
              schedule: Optional[RatioSchedule] = None,
              publish_interval: int = 0):
    """Compose actor + learner programs into one ``step(state) → (state,
    metrics)``.  Only the synchronous loop is ported: the async double
    buffer (``publish_interval > 0``) is refused."""
    if publish_interval != 0:
        raise NotImplementedError(
            "publish_interval > 0 (the async double buffer) is not ported; "
            "use publish_interval=0")
    schedule = schedule or RatioSchedule.from_config(cfg, n_envs)
    actor_step = make_actor_step(agent, v_step, n_envs)
    learn_fn = make_learner_step(agent, replay, cfg)

    def step(state: LoopState) -> Tuple[LoopState, Dict[str, Metric]]:
        gen = state.rng
        # 1. parallel actors on the fresh learner params
        eps = epsilon_schedule(cfg, state.env_steps)
        env_state, obs_next, ep_ret, last_ret, transitions = actor_step(
            state.agent, state.env_state, state.obs,
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
        loss = torch.zeros((), device=ep_ret.device)
        if can_learn:
            for i in range(schedule.learns):
                if lazy and i:
                    # extra learner calls must sample a consistent tree
                    replay_state = replay.flush(replay_state)
                agent_state, replay_state, lmetrics = learn_fn(
                    agent_state, replay_state, gen)
                loss = loss + lmetrics["loss"]
            loss = loss / schedule.learns
            learn_steps += schedule.learns

        # 5. lazy write, phase 2: storage write + P_max restore
        replay_state = replay.insert_commit(replay_state, slots, transitions,
                                            lazy=lazy)

        new_state = LoopState(
            agent=agent_state, replay=replay_state, env_state=env_state,
            obs=obs_next, rng=gen,
            env_steps=state.env_steps + schedule.env_steps_per_iter,
            episode_return=ep_ret, last_return=last_ret,
            learn_steps=learn_steps)
        metrics = {
            "loss": loss,
            "mean_episode_return": torch.mean(last_ret),
            "env_steps": new_state.env_steps,
            "learn_steps": learn_steps,
            "buffer_size": replay_state.count,
            "epsilon": eps,
        }
        return new_state, metrics

    return step


def init_loop_state(agent: Agent, replay: PrioritizedReplay, v_reset: Callable,
                    seed: int, n_envs: int) -> LoopState:
    """Initial state on the replay's device; one generator seeded with
    ``seed`` draws the env resets, the agent init and then the loop's
    random numbers."""
    gen = torch.Generator(device=replay.device)
    gen.manual_seed(seed)
    env_state, obs = v_reset(gen)
    agent_state = agent.init(gen)
    zeros = torch.zeros((n_envs,), dtype=torch.float32, device=replay.device)
    return LoopState(agent=agent_state, replay=replay.init(),
                     env_state=env_state, obs=obs, rng=gen, env_steps=0,
                     episode_return=zeros, last_return=zeros.clone(),
                     learn_steps=0)


def train(agent: Agent, replay: PrioritizedReplay, v_reset: Callable,
          v_step: Callable, cfg: LoopConfig, n_envs: int, iterations: int,
          seed: int, log_every: int = 0, scan_chunk: int = 64):
    """Run the fused loop — a thin wrapper over ``FusedExecutor`` for
    callers that hold (v_reset, v_step) instead of an env factory."""
    from repro_torch.runtime.executors import FusedExecutor  # lazy: avoid cycle

    ex = FusedExecutor(agent, replay, lambda _n: (None, v_reset, v_step),
                       cfg, n_envs, scan_chunk=scan_chunk, device=replay.device)
    return ex.train(iterations, seed, log_every)
