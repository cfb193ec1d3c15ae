"""DQN / DDQN learners (paper §II-C, Eq. 1-3) with PER importance
weights — port of ``repro.agents.dqn``."""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.agents.base import Agent, AgentState, mlp_init
from repro_torch.envs.classic import EnvSpec
from repro_torch.optim import adam


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    hidden: Tuple[int, ...] = (256, 256)
    gamma: float = 0.99
    tau: float = 0.005             # Polyak target update
    double_q: bool = False         # DDQN
    opt: adam.AdamConfig = adam.AdamConfig(lr=1e-3)


def make_dqn(spec: EnvSpec, cfg: DQNConfig) -> Agent:
    assert spec.discrete
    sizes = (spec.obs_dim, *cfg.hidden, spec.action_dim)

    def init(gen: torch.Generator) -> AgentState:
        params = mlp_init(gen, sizes)
        target = copy.deepcopy(params).requires_grad_(False)
        return AgentState(params=params, target=target,
                          opt=adam.init(params.parameters(), cfg.opt),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=gen.device))

    @torch.no_grad()
    def act(state: AgentState, obs: torch.Tensor, gen: torch.Generator,
            epsilon: float = 0.0) -> torch.Tensor:
        greedy = torch.argmax(state.params(obs), dim=-1)   # first max on ties
        rnd = torch.randint(0, spec.action_dim, greedy.shape, generator=gen,
                            device=obs.device)
        take_rnd = torch.rand(greedy.shape, generator=gen, device=obs.device) < epsilon
        return torch.where(take_rnd, rnd, greedy)

    def grads_fn(state: AgentState, batch: Dict[str, torch.Tensor],
                 is_w: torch.Tensor):
        """TD-loss gradients only — no optimizer step."""
        obs, act_, rew = batch["obs"], batch["action"], batch["reward"]
        nobs, done = batch["next_obs"], batch["done"]
        with torch.no_grad():
            q_next_t = state.target(nobs)
            if cfg.double_q:
                sel = torch.argmax(state.params(nobs), dim=-1)
                v_next = q_next_t.gather(1, sel[:, None])[:, 0]
            else:
                v_next = q_next_t.max(dim=-1).values
            tgt = rew + cfg.gamma * (1.0 - done) * v_next
        q = state.params(obs)
        q_sa = q.gather(1, act_[:, None].long())[:, 0]
        td = q_sa - tgt
        loss = torch.mean(is_w * torch.square(td))
        grads = torch.autograd.grad(loss, list(state.params.parameters()))
        td = td.detach()
        return list(grads), {"loss": loss.detach(), "td": td,
                             "q_mean": torch.mean(td + tgt)}

    def apply_fn(state: AgentState, grads, aux
                 ) -> Tuple[AgentState, Dict[str, torch.Tensor], torch.Tensor]:
        params = list(state.params.parameters())
        new_opt, gnorm = adam.update(grads, state.opt, params, cfg.opt)
        adam.ema_update(list(state.target.parameters()), params, cfg.tau)
        metrics = {"loss": aux["loss"], "grad_norm": gnorm, "q_mean": aux["q_mean"]}
        return (AgentState(state.params, state.target, new_opt, state.step + 1),
                metrics, aux["td"].abs())

    def learn(state: AgentState, batch, is_w
              ) -> Tuple[AgentState, Dict[str, torch.Tensor], torch.Tensor]:
        grads, aux = grads_fn(state, batch, is_w)
        return apply_fn(state, grads, aux)

    return Agent(name="ddqn" if cfg.double_q else "dqn", init=init, act=act,
                 learn=learn, grads=grads_fn, apply_grads=apply_fn)
