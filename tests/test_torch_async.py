"""The port's async executor (repro_torch.runtime.executors.AsyncExecutor,
no mesh): ports of tests/test_async_executor.py's fused-path tests.

At publish_interval=1 the acting copy is republished after every
iteration, so the run must be FusedExecutor's bit for bit from the same
seed; at publish_interval=4 the copy stays frozen between publishes and
CartPole still learns to the reference's bar (return > 30).  Whole runs
are held to that bar, not to the reference's trajectory (JAX's threefry
streams and torch's generators differ)."""

import functools

import torch

from repro_torch.agents import td3
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.quickstart import transition_example
from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor
from repro_torch.runtime.loop import LoopConfig

torch.set_num_threads(2)

ENV_FN = functools.partial(make_vec, "cartpole")


def _setup(capacity=1024):
    spec, _, _ = ENV_FN(1)
    agent = make_dqn(spec, DQNConfig())

    def mk_replay():
        return PrioritizedReplay(ReplayConfig(capacity=capacity, fanout=8),
                                 transition_example(spec), device="cpu")
    return agent, mk_replay


def _same(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_async_identity_reproduces_fused_exactly():
    cfg = LoopConfig(batch_size=32, warmup=8, epsilon=0.2)
    agent, mk_replay = _setup()
    fused = FusedExecutor(agent, mk_replay(), ENV_FN, cfg, n_envs=4, scan_chunk=16,
                          device="cpu")
    async_ex = AsyncExecutor(agent, mk_replay(), ENV_FN, cfg, n_envs=4,
                             publish_interval=1, scan_chunk=16,
                             device="cpu")
    assert fused.schedule == async_ex.schedule
    s1, h1 = fused.train(40, 7)
    s2, h2 = async_ex.train(40, 7)
    for k in h1:
        assert torch.equal(h1[k], h2[k]), k
    assert int(h1["learn_steps"][-1]) > 0
    assert _same(s1.agent.params, s2.agent.params)
    assert _same(s1.agent.target, s2.agent.target)
    # the async state carries the double buffer, synced at age 0, in
    # tensors of its own
    assert s1.actor_params is None and s2.params_age == 0
    assert _same(s2.actor_params, s2.agent.params)
    assert not any(x.data_ptr() == y.data_ptr() for x, y in
                   zip(s2.actor_params.parameters(), s2.agent.params.parameters()))


def test_async_staleness_delays_acting_copy():
    cfg = LoopConfig(batch_size=32, warmup=0, epsilon=0.2)
    agent, mk_replay = _setup()
    ex = AsyncExecutor(agent, mk_replay(), ENV_FN, cfg, n_envs=4, publish_interval=4,
                       scan_chunk=1, device="cpu")
    state = ex.init(3)
    ages, frozen = [], []
    prev = [p.clone() for p in state.actor_params.parameters()]
    for _ in range(12):
        state, _ = ex.run_chunk(state)
        ages.append(state.params_age)
        now = list(state.actor_params.parameters())
        frozen.append(all(torch.equal(a, b) for a, b in zip(prev, now)))
        prev = [p.clone() for p in now]
    # publish at the end of iterations 3, 7, 11 (it + 1 ≡ 0 mod 4)
    assert ages == [1, 2, 3, 0] * 3
    # the copy is untouched except on publish ticks, where the learner
    # has moved the fresh params away from it
    assert frozen == [age != 0 for age in ages]
    assert _same(state.actor_params, state.agent.params)


def test_async_publish4_still_learns_cartpole():
    cfg = LoopConfig(batch_size=64, warmup=400, epsilon=0.2)
    agent, mk_replay = _setup(capacity=20_000)
    ex = AsyncExecutor(agent, mk_replay(), ENV_FN, cfg, n_envs=8, publish_interval=4,
                       scan_chunk=64, device="cpu")
    state, hist = ex.train(1400, 1)
    final = float(hist["mean_episode_return"][-1])
    assert final > 30.0, final
    assert torch.isfinite(hist["loss"]).all()


def test_publish_copies_in_place_into_tensors_of_its_own():
    """A publish writes into the acting copy's existing tensors: across
    publishes the copy keeps its storage, which never is the learners'."""
    cfg = LoopConfig(batch_size=32, warmup=0, epsilon=0.2)
    agent, mk_replay = _setup()
    ex = AsyncExecutor(agent, mk_replay(), ENV_FN, cfg, n_envs=4, publish_interval=2,
                       scan_chunk=1, device="cpu")
    state = ex.init(5)
    ptrs = [p.data_ptr() for p in state.actor_params.parameters()]
    fresh = {p.data_ptr() for p in state.agent.params.parameters()}
    assert not fresh & set(ptrs)
    held = state.actor_params
    for _ in range(6):
        state, _ = ex.run_chunk(state)
    assert state.params_age == 0 and state.actor_params is held
    assert [p.data_ptr() for p in state.actor_params.parameters()] == ptrs
    assert not any(p.requires_grad for p in state.actor_params.parameters())
    assert _same(state.actor_params, state.agent.params)


def test_async_actor_critic_acts_on_the_whole_online_module():
    """The default double-buffer contract on a continuous agent: the copy
    is the whole online module (pi and the critics), actions stay inside
    Pendulum's bounds, and the copy lags the learners between publishes."""
    env_fn = functools.partial(make_vec, "pendulum")
    spec, _, _ = env_fn(1)
    agent = td3.make_td3(spec, td3.TD3Config(hidden=(16, 16)))
    replay = PrioritizedReplay(ReplayConfig(capacity=256, fanout=8),
                               transition_example(spec), device="cpu")
    ex = AsyncExecutor(agent, replay, env_fn, LoopConfig(batch_size=16, warmup=16,
                       epsilon=0.1), n_envs=4, publish_interval=3, scan_chunk=1,
                       device="cpu")
    state = ex.init(2)
    names = [n for n, _ in state.actor_params.named_parameters()]
    assert names == [n for n, _ in state.agent.params.named_parameters()]
    assert {n.split(".")[0] for n in names} == {"pi", "q1", "q2"}
    ages = []
    for _ in range(10):
        state, metrics = ex.run_chunk(state)
        ages.append(state.params_age)
        assert torch.isfinite(metrics["loss"])
    assert ages == [1, 2, 0] * 3 + [1]
    assert state.learn_steps > 0 and not _same(state.actor_params, state.agent.params)
    acts = replay.flush(state.replay).storage["action"][:40]
    assert acts.shape == (40, 1) and bool((acts.abs() <= 2.0).all())
