"""In-process service executor (DESIGN.md §11) — port of
``repro.service.executor``.

``ServiceExecutor`` drives a ``ReplayService``'s shard ops with the
actor and learner programs of ``runtime/loop.py``: the host owns the
window loop and the ``RateLimiter`` owns the learn cadence.  This is the
single-process form of the decoupled runtime: the same ops the TCP
server applies per request, driven in lockstep.

**Equivalence contract** (tests/test_torch_service.py): at
``n_shards=1`` with the limiter derived from the loop's ratio
(``RateLimiter.from_schedule``, the default), the executor is
``FusedExecutor`` bit for bit from the same seed.  Two ingredients make
that true:

- a window keeps ``make_step``'s op order — actor → insert_begin(lazy) →
  flush (the admission window boundary) → L× (sample → learn → priority
  write-back, a flush between learner calls) → insert_commit(lazy) — and
  its generator draws: the state's one ``torch.Generator`` feeds the
  actors, the env resets and each learner call's uniforms in that order
  (the reference's ``split → fold_in(shard) → split3`` key chain has no
  counterpart here);
- the greedy limiter drain (take batch-sized sample admissions until the
  debt band blocks) reproduces ``RatioSchedule``'s cadence exactly when
  ``error_buffer`` is the per-event sample quota and ``warmup`` is a
  multiple of the learn period's env steps (otherwise the limiter starts
  learning up to one period earlier than the modulo-phased schedule; the
  *ratio* still holds, the phase differs).

At ``n_shards > 1`` each window's transition batch goes to the shard the
router picks, and a learner call samples stratified (B/N a shard, the
uniforms of shard 0 drawn first) with importance weights normalized
against the global distribution (``server.stratified_sample``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.agents.base import Agent
from repro_torch.runtime.executors import Executor
from repro_torch.runtime.loop import (LoopConfig, LoopState, Metric, RatioSchedule,
                                      epsilon_schedule, init_loop_state, make_actor_step,
                                      make_learner_step)
from repro_torch.service.rate_limiter import RateLimiter
from repro_torch.service.server import ReplayService, stratified_sample


class ServiceExecutor(Executor):
    """Train against an in-process ``ReplayService``.

    The shard states ride in the carried ``LoopState`` (``state.replay``
    is the tuple of shard states), so the standard ``Executor.run``
    driver works unchanged; the service supplies the shard ops, the
    router and the rate limiter, and its device is the executor's.
    """

    def __init__(
        self,
        agent: Agent,
        service: ReplayService,
        env_fn: Callable[[int], tuple],
        cfg: LoopConfig,
        n_envs: int,
        scan_chunk: int = 64,
        rate_limiter: Optional[RateLimiter] = None,
    ):
        n = service.config.n_shards
        if cfg.batch_size % n:
            raise ValueError(
                f"batch_size={cfg.batch_size} must divide evenly over "
                f"n_shards={n} (stratified sampling draws B/N per shard)")
        self.agent = agent
        self.service = service
        self.replay = service.replay
        self.device = service.device
        self.cfg = cfg
        self.n_envs = n_envs
        self.n_shards = n
        self.scan_chunk = scan_chunk
        self.spec, self._v_reset, self._v_step = env_fn(n_envs)
        self.schedule = RatioSchedule.from_config(cfg, n_envs)
        self.limiter = (rate_limiter or service.limiter
                        or RateLimiter.from_schedule(
                            self.schedule, cfg.batch_size, cfg.warmup))
        self._window_count = 0
        self._actor = make_actor_step(agent, self._v_step, n_envs)
        self._learn1 = make_learner_step(agent, service.replay, cfg)

    # -- one window ----------------------------------------------------------

    def _stratified_learn(self, agent_state, states, gen):
        per = self.cfg.batch_size // self.n_shards
        us = [torch.rand((per,), generator=gen, device=self.device)
              for _ in range(self.n_shards)]
        idxs, items, w = stratified_sample(self.replay, states, us, self.cfg.beta)
        agent_state, metrics, td = self.agent.learn(agent_state, items, w)
        states = [self.replay.update_priorities(s, idxs[i], td[i * per:(i + 1) * per],
                                                lazy=True)
                  for i, s in enumerate(states)]
        return agent_state, states, metrics["loss"]

    def _window(self, state: LoopState, target: int, n_learns: int
                ) -> Tuple[LoopState, Dict[str, Metric]]:
        rb, cfg = self.replay, self.cfg
        gen = state.rng
        eps = epsilon_schedule(cfg, state.env_steps)

        # 1. actor program
        env_state, obs_next, ep_ret, last_ret, transitions = self._actor(
            state.agent, state.env_state, state.obs,
            state.episode_return, state.last_return, gen, eps)

        # 2. writer transaction phase 1 on the routed shard
        states = list(state.replay)
        states[target], slots = rb.insert_begin(states[target], self.n_envs, lazy=True)

        # 3. the admission-window boundary: one propagation pass per shard
        #    with pending lazy writes
        states = [rb.flush(s) for s in states]

        # 4. learner program, as many times as the limiter admitted
        agent_state = state.agent
        loss = torch.zeros((), device=ep_ret.device)
        for i in range(n_learns):
            if i:
                states = [rb.flush(s) for s in states]
            if self.n_shards == 1:
                agent_state, states[0], lmetrics, _ = self._learn1(agent_state, states[0], gen)
                loss = loss + lmetrics["loss"]
            else:
                agent_state, states, lvalue = self._stratified_learn(agent_state, states, gen)
                loss = loss + lvalue
        loss = loss / max(1, n_learns)

        # 5. writer transaction phase 2
        states[target] = rb.insert_commit(states[target], slots, transitions, lazy=True)

        new_state = state._replace(
            agent=agent_state, replay=tuple(states), env_state=env_state,
            obs=obs_next, rng=gen, env_steps=state.env_steps + self.n_envs,
            episode_return=ep_ret, last_return=last_ret,
            learn_steps=state.learn_steps + n_learns)
        metrics = {
            "loss": loss,
            "mean_episode_return": torch.mean(last_ret),
            "env_steps": new_state.env_steps,
            "learn_steps": new_state.learn_steps,
            "buffer_size": sum(s.count for s in states),
            "epsilon": eps,
            "compress_error_norm": 0.0,
        }
        return new_state, metrics

    # -- Executor API -------------------------------------------------------

    def step(self, state: LoopState) -> Tuple[LoopState, Dict[str, Metric]]:
        """One window: the greedy limiter drain decides the learn count
        (``RatioSchedule`` generalized), the router the target shard."""
        n_learns = 0
        while (not self.limiter.stopped
               and self.limiter.can_sample(self.cfg.batch_size)):
            self.limiter.note_sample(self.cfg.batch_size)
            n_learns += 1
        target = self.service.router.route(f"window-{self._window_count}")
        self._window_count += 1
        state, metrics = self._window(state, target, n_learns)
        self.limiter.note_insert(self.n_envs)
        return state, metrics

    def init(self, seed: int) -> LoopState:
        """``loop.init_loop_state`` on the service's replay (the fused
        loop's draws), with one fresh state a shard."""
        st = init_loop_state(self.agent, self.replay, self._v_reset, seed, self.n_envs)
        return st._replace(replay=(st.replay,) + tuple(
            self.replay.init() for _ in range(self.n_shards - 1)))

    def realized_samples_per_insert(self) -> float:
        return self.limiter.realized_samples_per_insert()
