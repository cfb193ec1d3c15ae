"""Two public names of the reference that the port mirrors:
``runtime/loop.py::make_parallel_step`` (the compat wrapper over
``make_step``) and ``configs.all_configs``, each held to the reference.

JAX's and torch's random streams differ, so the parallel step is held to
the reference on what does not depend on them (its metric keys, the
env-step, learn-step and buffer counters, exact) and to the port's own
``make_step`` bit for bit; the configs compare field for field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents.dqn import DQNConfig as JDQNConfig
from repro.agents.dqn import make_dqn as jmake_dqn
from repro.configs import all_configs as ref_all_configs
from repro.core.replay import PrioritizedReplay as JReplay
from repro.core.replay import ReplayConfig as JReplayConfig
from repro.envs.classic import make_vec as jmake_vec
from repro.runtime import loop as jloop
from repro_torch.agents.base import state_tensors
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.configs import all_configs
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.quickstart import transition_example
from repro_torch.runtime import loop

STEPS = 12
KW = dict(batch_size=16, warmup=24, update_interval=8, epsilon=0.3)


def _port_run(make):
    spec, v_reset, v_step = make_vec("cartpole", 4)
    agent = make_dqn(spec, DQNConfig(hidden=(32, 32)))
    replay = PrioritizedReplay(ReplayConfig(capacity=64, fanout=8), transition_example(spec),
                               device="cpu")
    step = make(agent, replay, v_step, loop.LoopConfig(**KW), 4)
    state = loop.init_loop_state(agent, replay, v_reset, 0, 4)
    hist = []
    for _ in range(STEPS):
        state, metrics = step(state)
        hist.append(metrics)
    return state, hist


def test_make_parallel_step_matches_reference_counters():
    spec, v_reset, v_step = jmake_vec("cartpole", 4)
    agent = jmake_dqn(spec, JDQNConfig(hidden=(32, 32)))
    example = {"obs": jnp.zeros((4,), jnp.float32), "action": jnp.zeros((), jnp.int32),
               "reward": jnp.zeros(()), "next_obs": jnp.zeros((4,), jnp.float32),
               "done": jnp.zeros(())}
    replay = JReplay(JReplayConfig(capacity=64, fanout=8), example)
    step = jax.jit(jloop.make_parallel_step(agent, replay, v_step, jloop.LoopConfig(**KW), 4))
    jstate = jloop.init_loop_state(agent, replay, v_reset, jax.random.PRNGKey(0), 4)
    jhist = []
    for _ in range(STEPS):
        jstate, metrics = step(jstate)
        jhist.append(metrics)
    _, hist = _port_run(loop.make_parallel_step)
    assert set(hist[0]) == set(jhist[0]) == set(loop.METRIC_KEYS)
    for k in ("env_steps", "learn_steps", "buffer_size"):
        np.testing.assert_array_equal([int(h[k]) for h in hist], [int(h[k]) for h in jhist],
                                      err_msg=k)
    assert int(hist[-1]["learn_steps"]) > 0


def test_make_parallel_step_is_make_step():
    a, ha = _port_run(loop.make_parallel_step)
    b, hb = _port_run(loop.make_step)
    ta, tb = state_tensors(a.agent), state_tensors(b.agent)
    assert ta.keys() == tb.keys()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert torch.equal(a.replay.tree, b.replay.tree) and torch.equal(a.obs, b.obs)
    assert all(torch.equal(torch.as_tensor(x[k]), torch.as_tensor(y[k]))
               for x, y in zip(ha, hb) for k in x)


@pytest.mark.parametrize("smoke", [True, False])
def test_all_configs_match_reference(smoke):
    got, want = all_configs(smoke), ref_all_configs(smoke)
    assert list(got) == list(want)
    for arch in want:
        assert dataclasses.asdict(got[arch]) == dataclasses.asdict(want[arch]), arch
