"""TD3 learner — twin critics, delayed policy, target smoothing — port of
``repro.agents.td3``.

The reference draws the target-smoothing noise from
``fold_in(PRNGKey(17), step)``, a stream of its own.  Here that stream is
a ``torch.Generator`` on the state's device seeded with ``LEARN_SEED``,
held in ``AgentState.extra`` (and saved with the checkpoint), never the
loop's generator.  ``learn(..., noise=eps)`` takes the standard-normal
draws instead, so a test can hand it the reference's own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.agents.base import Agent, AgentState, actor_critic_state, q_value
from repro_torch.envs.classic import EnvSpec
from repro_torch.optim import adam

LEARN_SEED = 17


@dataclasses.dataclass(frozen=True)
class TD3Config:
    hidden: Tuple[int, ...] = (256, 256)
    gamma: float = 0.99
    tau: float = 0.005
    expl_noise: float = 0.1
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    opt: adam.AdamConfig = adam.AdamConfig(lr=1e-3)


def make_td3(spec: EnvSpec, cfg: TD3Config) -> Agent:
    assert not spec.discrete
    scale = (spec.action_high - spec.action_low) / 2.0
    mid = (spec.action_high + spec.action_low) / 2.0

    def pi(net, obs):
        return torch.tanh(net(obs)) * scale + mid

    def init(gen: torch.Generator) -> AgentState:
        q_sizes = (spec.obs_dim + spec.action_dim, *cfg.hidden, 1)
        return actor_critic_state(
            gen, cfg.opt, {"pi": (spec.obs_dim, *cfg.hidden, spec.action_dim),
                           "q1": q_sizes, "q2": q_sizes},
            extra=(torch.Generator(device=gen.device).manual_seed(LEARN_SEED),))

    @torch.no_grad()
    def act(state: AgentState, obs: torch.Tensor, gen: torch.Generator,
            epsilon: float = 0.0) -> torch.Tensor:
        a = pi(state.params["pi"], obs)
        if epsilon > 0:
            a = a + torch.randn(a.shape, generator=gen, device=obs.device) * (
                cfg.expl_noise * scale)
        return torch.clamp(a, spec.action_low, spec.action_high)

    def learn(state: AgentState, batch: Dict[str, torch.Tensor], is_w: torch.Tensor,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[AgentState, Dict[str, torch.Tensor], torch.Tensor]:
        """``noise``: the (B, action_dim) standard-normal draws of the
        target smoothing; by default drawn from the state's generator."""
        obs, act_, rew = batch["obs"], batch["action"], batch["reward"]
        nobs, done = batch["next_obs"], batch["done"]
        if noise is None:
            (gen,) = state.extra
            noise = torch.randn(act_.shape, generator=gen, device=gen.device)
        net = state.params
        with torch.no_grad():
            smooth = torch.clamp(noise * cfg.policy_noise, -cfg.noise_clip,
                                 cfg.noise_clip) * scale
            a_next = torch.clamp(pi(state.target["pi"], nobs) + smooth,
                                 spec.action_low, spec.action_high)
            v_next = torch.minimum(q_value(state.target["q1"], nobs, a_next),
                                   q_value(state.target["q2"], nobs, a_next))
            tgt = rew + cfg.gamma * (1.0 - done) * v_next
        # decided on the device: no host read of the step counter
        do_policy = (state.step % cfg.policy_delay) == 0
        td1 = q_value(net["q1"], obs, act_) - tgt
        td2 = q_value(net["q2"], obs, act_) - tgt
        critic = torch.mean(is_w * (torch.square(td1) + torch.square(td2)))
        actor = -torch.mean(q_value(net["q1"], obs, pi(net["pi"], obs)))
        # off a policy step pi's gradient is zero, but Adam still steps pi
        # on its momentum, as in the reference
        actor = torch.where(do_policy, actor, torch.zeros_like(actor))
        q_params = list(net["q1"].parameters()) + list(net["q2"].parameters())
        grads = (torch.autograd.grad(actor, list(net["pi"].parameters()))
                 + torch.autograd.grad(critic, q_params))
        params = list(net.parameters())
        new_opt, gnorm = adam.update(grads, state.opt, params, cfg.opt)
        # the whole target tree moves on policy steps only
        adam.ema_update(list(state.target.parameters()), params, cfg.tau, where=do_policy)
        td = 0.5 * (td1.detach().abs() + td2.detach().abs())
        return (AgentState(net, state.target, new_opt, state.step + 1, state.extra),
                {"loss": (critic + actor).detach(), "grad_norm": gnorm}, td)

    return Agent("td3", init, act, learn)
