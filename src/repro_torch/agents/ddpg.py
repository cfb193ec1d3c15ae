"""DDPG learner (the paper's continuous-action algorithm set) — port of
``repro.agents.ddpg``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.agents.base import Agent, AgentState, actor_critic_state, q_value
from repro_torch.envs.classic import EnvSpec
from repro_torch.optim import adam


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    hidden: Tuple[int, ...] = (256, 256)
    gamma: float = 0.99
    tau: float = 0.005
    expl_noise: float = 0.1
    opt: adam.AdamConfig = adam.AdamConfig(lr=1e-3)


def make_ddpg(spec: EnvSpec, cfg: DDPGConfig) -> Agent:
    assert not spec.discrete
    scale = (spec.action_high - spec.action_low) / 2.0
    mid = (spec.action_high + spec.action_low) / 2.0

    def pi(net, obs):
        return torch.tanh(net(obs)) * scale + mid

    def init(gen: torch.Generator) -> AgentState:
        return actor_critic_state(gen, cfg.opt, {
            "pi": (spec.obs_dim, *cfg.hidden, spec.action_dim),
            "q": (spec.obs_dim + spec.action_dim, *cfg.hidden, 1)})

    @torch.no_grad()
    def act(state: AgentState, obs: torch.Tensor, gen: torch.Generator,
            epsilon: float = 0.0) -> torch.Tensor:
        a = pi(state.params["pi"], obs)
        if epsilon > 0:
            a = a + torch.randn(a.shape, generator=gen, device=obs.device) * (
                cfg.expl_noise * scale)
        return torch.clamp(a, spec.action_low, spec.action_high)

    def learn(state: AgentState, batch: Dict[str, torch.Tensor], is_w: torch.Tensor
              ) -> Tuple[AgentState, Dict[str, torch.Tensor], torch.Tensor]:
        obs, act_, rew = batch["obs"], batch["action"], batch["reward"]
        nobs, done = batch["next_obs"], batch["done"]
        net = state.params
        with torch.no_grad():
            a_next = pi(state.target["pi"], nobs)
            tgt = rew + cfg.gamma * (1.0 - done) * q_value(state.target["q"], nobs, a_next)
        td = q_value(net["q"], obs, act_) - tgt
        critic = torch.mean(is_w * torch.square(td))
        # the reference's stop_gradient(params)["q"]: the actor term's
        # gradient reaches pi only, through q's activations
        actor = -torch.mean(q_value(net["q"], obs, pi(net["pi"], obs)))
        grads = (torch.autograd.grad(actor, list(net["pi"].parameters()))
                 + torch.autograd.grad(critic, list(net["q"].parameters())))
        params = list(net.parameters())
        new_opt, gnorm = adam.update(grads, state.opt, params, cfg.opt)
        adam.ema_update(list(state.target.parameters()), params, cfg.tau)
        return (AgentState(net, state.target, new_opt, state.step + 1),
                {"loss": (critic + actor).detach(), "grad_norm": gnorm}, td.detach().abs())

    return Agent("ddpg", init, act, learn)
