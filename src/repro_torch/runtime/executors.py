"""Executor layer — port of ``repro.runtime.executors`` (the fused
single-device executor; the sharded and async executors are not ported
yet).

``FusedExecutor`` runs the composed step (runtime/loop.py) in chunks of
``scan_chunk`` iterations: a Python loop takes the place of the
reference's ``lax.scan``.  ``Executor.run`` performs exactly the
requested number of iterations (full chunks plus one tail) and keeps the
last iteration's metrics of each chunk as ``history``; it reads device
values back only when it logs and once at the end.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.agents.base import Agent
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.loop import (LoopConfig, LoopState, Metric,
                                      RatioSchedule, init_loop_state, make_step)

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
    ``publish_interval`` (the async double buffer) must be 0."""

    def __init__(
        self,
        agent: Agent,
        replay: PrioritizedReplay,
        env_fn: Callable[[int], tuple],
        cfg: LoopConfig,
        n_envs: int,
        scan_chunk: int = 64,
        publish_interval: int = 0,
        device: DeviceLike = "cuda",
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
        self.spec, self._v_reset, self._v_step = env_fn(n_envs)
        self.schedule = RatioSchedule.from_config(cfg, n_envs)
        self.step = make_step(agent, replay, self._v_step, cfg, n_envs,
                              schedule=self.schedule,
                              publish_interval=publish_interval)

    def init(self, seed: int) -> LoopState:
        return init_loop_state(self.agent, self.replay, self._v_reset, seed,
                               self.n_envs)
