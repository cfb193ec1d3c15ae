"""SAC learner — tanh-Gaussian actor, twin critics, learned temperature
— port of ``repro.agents.sac``.

``AgentState.extra`` is ``(log_alpha, alpha_opt, generator)``: the 0-d
f32 log-temperature, its own ``AdamState`` under the same ``AdamConfig``
(so the clip applies to its gradient too), and the learn-time stream.
The reference draws it from ``fold_in(PRNGKey(23), step)``; here it is a
``torch.Generator`` on the state's device seeded with ``LEARN_SEED``,
never the loop's.  ``learn(..., noise=(eps_next, eps_pi))`` takes the
standard-normal draws instead, so a test can hand it the reference's own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.agents.base import Agent, AgentState, actor_critic_state, q_value
from repro_torch.envs.classic import EnvSpec
from repro_torch.optim import adam

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0
LEARN_SEED = 23


@dataclasses.dataclass(frozen=True)
class SACConfig:
    hidden: Tuple[int, ...] = (256, 256)
    gamma: float = 0.99
    tau: float = 0.005
    init_alpha: float = 0.2
    learn_alpha: bool = True
    opt: adam.AdamConfig = adam.AdamConfig(lr=3e-4)


def make_sac(spec: EnvSpec, cfg: SACConfig) -> Agent:
    assert not spec.discrete
    scale = (spec.action_high - spec.action_low) / 2.0
    mid = (spec.action_high + spec.action_low) / 2.0
    target_entropy = -float(spec.action_dim)

    def actor_dist(net, obs):
        mu, log_std = torch.chunk(net(obs), 2, dim=-1)
        return mu, torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))

    def sample_action(net, obs, eps):
        """(scaled action, log-prob) of the draw ``eps`` ~ N(0, 1)."""
        mu, std = actor_dist(net, obs)
        a = torch.tanh(mu + std * eps)
        # log prob with the tanh correction, on the action before scaling
        logp = (-0.5 * (eps**2 + math.log(2 * math.pi)) - torch.log(std)).sum(-1)
        logp = logp - torch.sum(torch.log(1 - a**2 + 1e-6), dim=-1)
        return a * scale + mid, logp

    def init(gen: torch.Generator) -> AgentState:
        q_sizes = (spec.obs_dim + spec.action_dim, *cfg.hidden, 1)
        log_alpha = torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32,
                                 device=gen.device)
        return actor_critic_state(
            gen, cfg.opt, {"pi": (spec.obs_dim, *cfg.hidden, 2 * spec.action_dim),
                           "q1": q_sizes, "q2": q_sizes},
            extra=(log_alpha, adam.init([log_alpha], cfg.opt),
                   torch.Generator(device=gen.device).manual_seed(LEARN_SEED)))

    @torch.no_grad()
    def act(state: AgentState, obs: torch.Tensor, gen: torch.Generator,
            epsilon: float = 0.0) -> torch.Tensor:
        net = state.params["pi"]
        if epsilon > 0:
            eps = torch.randn((obs.shape[0], spec.action_dim), generator=gen,
                              device=obs.device)
            return sample_action(net, obs, eps)[0]
        return torch.tanh(actor_dist(net, obs)[0]) * scale + mid

    def learn(state: AgentState, batch: Dict[str, torch.Tensor], is_w: torch.Tensor,
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[AgentState, Dict[str, torch.Tensor], torch.Tensor]:
        """``noise``: the (B, action_dim) standard-normal draws of the next
        action and of the actor's action; by default drawn from the
        state's generator, in that order."""
        obs, act_, rew = batch["obs"], batch["action"], batch["reward"]
        nobs, done = batch["next_obs"], batch["done"]
        log_alpha, alpha_opt, gen = state.extra
        if noise is None:
            noise = tuple(torch.randn(act_.shape, generator=gen, device=gen.device)
                          for _ in range(2))
        eps_next, eps_pi = noise
        alpha = torch.exp(log_alpha)       # the old α: log_alpha moves in place below
        net = state.params
        with torch.no_grad():
            # the next action from the online pi
            a_next, logp_next = sample_action(net["pi"], nobs, eps_next)
            v_next = torch.minimum(q_value(state.target["q1"], nobs, a_next),
                                   q_value(state.target["q2"], nobs, a_next)) - alpha * logp_next
            tgt = rew + cfg.gamma * (1.0 - done) * v_next
        td1 = q_value(net["q1"], obs, act_) - tgt
        td2 = q_value(net["q2"], obs, act_) - tgt
        critic = torch.mean(is_w * (torch.square(td1) + torch.square(td2)))
        a_pi, logp = sample_action(net["pi"], obs, eps_pi)
        q_pi = torch.minimum(q_value(net["q1"], obs, a_pi), q_value(net["q2"], obs, a_pi))
        actor = torch.mean(alpha * logp - q_pi)
        q_params = list(net["q1"].parameters()) + list(net["q2"].parameters())
        grads = (torch.autograd.grad(actor, list(net["pi"].parameters()))
                 + torch.autograd.grad(critic, q_params))
        params = list(net.parameters())
        new_opt, gnorm = adam.update(grads, state.opt, params, cfg.opt)
        adam.ema_update(list(state.target.parameters()), params, cfg.tau)
        if cfg.learn_alpha:
            # d/dla of -exp(la)·mean(logp + H̄), logp of the actor's draw, detached
            ga = -torch.exp(log_alpha) * torch.mean(logp.detach() + target_entropy)
            alpha_opt, _ = adam.update([ga], alpha_opt, [log_alpha], cfg.opt)
        td = 0.5 * (td1.detach().abs() + td2.detach().abs())
        return (AgentState(net, state.target, new_opt, state.step + 1,
                           (log_alpha, alpha_opt, gen)),
                {"loss": (critic + actor).detach(), "grad_norm": gnorm, "alpha": alpha}, td)

    return Agent("sac", init, act, learn)
