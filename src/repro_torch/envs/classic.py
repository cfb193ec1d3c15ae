"""Batched control environments on torch tensors — port of
``repro.envs.classic`` (CartPole for the discrete learners, Pendulum for
the continuous ones).

Every env of a batch steps in one set of tensor ops, in f32, on the
device of the state.  Random numbers come from the ``torch.Generator``
passed in, and the state is created on that generator's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    action_dim: int           # discrete: number of actions; continuous: dim
    discrete: bool
    max_steps: int
    action_low: float = -1.0
    action_high: float = 1.0


class EnvState(NamedTuple):
    x: torch.Tensor        # (E, state_dim) f32 physics state
    t: torch.Tensor        # (E,) int32 step counter


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


# ---------------------------------------------------------------- CartPole

CARTPOLE = EnvSpec("cartpole", 4, 2, True, 500)

_G, _MC, _MP, _L, _F, _DT = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02


def cartpole_reset(gen: torch.Generator, n: int) -> Tuple[EnvState, torch.Tensor]:
    x = _uniform(gen, (n, 4), -0.05, 0.05)
    return EnvState(x, torch.zeros((n,), dtype=torch.int32, device=x.device)), x


def cartpole_step(state: EnvState, action: torch.Tensor):
    x, x_dot, th, th_dot = state.x.unbind(-1)
    force = torch.where(action == 1, _F, -_F).to(torch.float32)
    cos, sin = torch.cos(th), torch.sin(th)
    tot_m = _MC + _MP
    tmp = (force + _MP * _L * th_dot**2 * sin) / tot_m
    th_acc = (_G * sin - cos * tmp) / (_L * (4.0 / 3.0 - _MP * cos**2 / tot_m))
    x_acc = tmp - _MP * _L * th_acc * cos / tot_m
    nx = torch.stack([x + _DT * x_dot, x_dot + _DT * x_acc,
                      th + _DT * th_dot, th_dot + _DT * th_acc], dim=-1)
    t = state.t + 1
    done = ((nx[:, 0].abs() > 2.4) | (nx[:, 2].abs() > 0.2095)
            | (t >= CARTPOLE.max_steps))
    return EnvState(nx, t), nx, torch.ones_like(x), done


# ---------------------------------------------------------------- Pendulum

PENDULUM = EnvSpec("pendulum", 3, 1, False, 200, -2.0, 2.0)


def _pend_obs(x: torch.Tensor) -> torch.Tensor:
    th, th_dot = x.unbind(-1)
    return torch.stack([torch.cos(th), torch.sin(th), th_dot], dim=-1)


def pendulum_reset(gen: torch.Generator, n: int) -> Tuple[EnvState, torch.Tensor]:
    th = _uniform(gen, (n,), -math.pi, math.pi)
    thd = _uniform(gen, (n,), -1.0, 1.0)
    x = torch.stack([th, thd], dim=-1)
    return (EnvState(x, torch.zeros((n,), dtype=torch.int32, device=x.device)),
            _pend_obs(x))


def pendulum_step(state: EnvState, action: torch.Tensor):
    th, th_dot = state.x.unbind(-1)
    u = torch.clamp(action.reshape(th.shape), -2.0, 2.0)
    norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
    cost = norm_th**2 + 0.1 * th_dot**2 + 0.001 * u**2
    new_thd = th_dot + (3 * 9.81 / (2 * 1.0) * torch.sin(th) + 3.0 / 1.0 * u) * 0.05
    new_thd = torch.clamp(new_thd, -8.0, 8.0)
    new_th = th + new_thd * 0.05
    x = torch.stack([new_th, new_thd], dim=-1)
    t = state.t + 1
    done = t >= PENDULUM.max_steps
    return EnvState(x, t), _pend_obs(x), -cost, done


# ---------------------------------------------------------- registry / vector

ENVS = {
    "cartpole": (CARTPOLE, cartpole_reset, cartpole_step),
    "pendulum": (PENDULUM, pendulum_reset, pendulum_step),
}


def make_vec(name: str, n_envs: int) -> Tuple[EnvSpec, Callable, Callable]:
    """Batched auto-resetting environment (the paper's parallel actors:
    each actor owns one env of the batch).

    ``v_reset(gen) → (state, obs)``;
    ``v_step(state, actions, gen) → (state, obs, reward, done, true_next)``
    where ``obs`` is already reset for finished episodes and
    ``true_next`` is the next observation from before the reset.
    """
    spec, reset, step = ENVS[name]

    def v_reset(gen: torch.Generator):
        return reset(gen, n_envs)

    def v_step(states: EnvState, actions: torch.Tensor, gen: torch.Generator):
        nstates, obs, rew, done = step(states, actions)
        rstates, robs = reset(gen, n_envs)
        nstates = EnvState(torch.where(done[:, None], rstates.x, nstates.x),
                           torch.where(done, rstates.t, nstates.t))
        obs_out = torch.where(done[:, None], robs, obs)
        return nstates, obs_out, rew, done, obs

    return spec, v_reset, v_step
