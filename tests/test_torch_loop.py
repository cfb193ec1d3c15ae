"""The port's training loop and fused executor (repro_torch.runtime)
against the JAX reference: the ratio schedule, exact iteration counts,
one propagation pass per lazy iteration (op counters), one learner call
on carried state, the step-count histories of a whole run, and the
end-to-end CartPole run held to the reference's bar.

JAX's threefry streams and torch's generators differ, so whole runs are
compared on what does not depend on random numbers (the counters) and
held to the reference's acceptance bar (return > 30), not to its
trajectory.  Tolerances of the one learner call: loss, params and tree
rtol 1e-5; indices exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents.dqn import DQNConfig as JDQNConfig
from repro.agents.dqn import make_dqn as jmake_dqn
from repro.core.replay import PrioritizedReplay as JReplay
from repro.core.replay import ReplayConfig as JReplayConfig
from repro.envs.classic import make_vec as jmake_vec
from repro.runtime import executors as jexec
from repro.runtime import loop as jloop
from repro_torch import interop
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core import sumtree as tst
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.quickstart import transition_example
from repro_torch.runtime import loop
from repro_torch.runtime.executors import FusedExecutor
from repro_torch.runtime.loop import LoopConfig, RatioSchedule

torch.set_num_threads(2)

ENV_FN = functools.partial(make_vec, "cartpole")


def jexample(obs_dim=4):
    return {"obs": jnp.zeros((obs_dim,), jnp.float32),
            "action": jnp.zeros((), jnp.int32), "reward": jnp.zeros(()),
            "next_obs": jnp.zeros((obs_dim,), jnp.float32), "done": jnp.zeros(())}


def executor(cfg, capacity=2048, fanout=8, n_envs=4, scan_chunk=16, backend=None,
             hidden=(256, 256)):
    spec, _, _ = ENV_FN(1)
    replay = PrioritizedReplay(ReplayConfig(capacity=capacity, fanout=fanout,
                                            backend=backend),
                               transition_example(spec), device="cpu")
    return FusedExecutor(make_dqn(spec, DQNConfig(hidden=hidden)), replay, ENV_FN,
                         cfg, n_envs, scan_chunk=scan_chunk, device="cpu")


def test_ratio_schedule_math():
    s = RatioSchedule.from_config(LoopConfig(update_interval=32), 8)
    assert (s.period, s.learns) == (4, 1) and s.realized_ratio == 32.0
    s = RatioSchedule.from_config(LoopConfig(update_interval=2), 8)
    assert (s.period, s.learns) == (1, 4) and s.realized_ratio == 2.0
    s = RatioSchedule.from_config(LoopConfig(update_interval=8, learns_per_step=2), 8)
    assert (s.period, s.learns) == (1, 2) and s.realized_ratio == 4.0
    for u, e, lps in [(32, 8, 1), (2, 8, 1), (8, 8, 2), (3, 8, 3), (100, 7, 1)]:
        want = jloop.RatioSchedule.from_config(
            jloop.LoopConfig(update_interval=u, learns_per_step=lps), e)
        got = RatioSchedule.from_config(LoopConfig(update_interval=u,
                                                   learns_per_step=lps), e)
        assert (got.period, got.learns, got.env_steps_per_iter) == \
            (want.period, want.learns, want.env_steps_per_iter)


def test_epsilon_schedule_matches_reference():
    cfg = LoopConfig(epsilon=0.3, epsilon_final=0.05, epsilon_decay_steps=1000)
    jcfg = jloop.LoopConfig(epsilon=0.3, epsilon_final=0.05, epsilon_decay_steps=1000)
    for steps in (0, 1, 500, 999, 1000, 5000):
        np.testing.assert_allclose(
            loop.epsilon_schedule(cfg, steps),
            float(jloop.epsilon_schedule(jcfg, jnp.asarray(steps, jnp.int32))),
            rtol=1e-6)


@pytest.mark.parametrize("iterations,scan_chunk", [(10, 16), (100, 64), (37, 16),
                                                   (64, 64)])
def test_run_performs_exact_iteration_count(iterations, scan_chunk):
    ex = executor(LoopConfig(batch_size=32, warmup=0, epsilon=0.3),
                  scan_chunk=scan_chunk, hidden=(32, 32))
    state, hist = ex.train(iterations, 0)
    assert state.env_steps == iterations * 4
    assert int(hist["env_steps"][-1]) == iterations * 4
    assert hist["env_steps"].shape[0] == -(-iterations // scan_chunk)
    assert int(hist["learn_steps"][-1]) == iterations * 4


def _one_step_counts(lazy_replay, backend):
    # update_interval == n_envs: exactly one learner call per iteration
    ex = executor(LoopConfig(batch_size=32, warmup=0, update_interval=4,
                             lazy_replay=lazy_replay), capacity=512,
                  backend=backend, hidden=(32, 32))
    state = ex.init(0)
    ex.replay.ops.counts.clear()
    ex.step(state)
    return ex.replay.ops.counts


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loop_lazy_single_propagation_pass_per_iteration(backend):
    counts = _one_step_counts(lazy_replay=True, backend=backend)
    assert counts["flush"] == 1
    assert counts["update"] == 0
    assert counts["write_leaves"] == 3     # begin + priority write-back + commit
    assert counts["sample"] == 1 and counts["gather"] == 5

    counts = _one_step_counts(lazy_replay=False, backend=backend)
    assert counts["flush"] == 0
    assert counts["update"] == 3           # the eager baseline


def test_one_learner_call_matches_reference():
    """Carry the reference's agent and replay state across, feed the same
    uniform draws, and compare sample → learn → write-back."""
    spec, _, _ = jmake_vec("cartpole", 1)
    jagent = jmake_dqn(spec, JDQNConfig(double_q=True))
    jreplay = JReplay(JReplayConfig(capacity=512, fanout=8), jexample())
    jcfg = jloop.LoopConfig(batch_size=32)
    rng = np.random.default_rng(0)
    data = {"obs": rng.normal(size=(300, 4)).astype(np.float32),
            "action": rng.integers(0, 2, 300).astype(np.int32),
            "reward": np.ones(300, np.float32),
            "next_obs": rng.normal(size=(300, 4)).astype(np.float32),
            "done": (rng.uniform(size=300) < 0.1).astype(np.float32)}
    jrs = jreplay.insert(jreplay.init(), jax.tree.map(jnp.asarray, data))
    jrs = jreplay.update_priorities(jrs, jnp.arange(300),
                                    jnp.asarray(rng.uniform(0, 2, 300).astype(np.float32)))
    jas = jagent.init(jax.random.PRNGKey(1))
    tas = interop.agent_state_from_numpy(jax.device_get(jas))
    trs = interop.replay_state_from_numpy(jax.device_get(jrs))
    key = jax.random.PRNGKey(7)
    jas2, jrs2, jm, _ = jloop.make_learner_step(jagent, jreplay, jcfg)(jas, jrs, key)

    tagent = make_dqn(spec, DQNConfig(double_q=True))
    treplay = PrioritizedReplay(ReplayConfig(capacity=512, fanout=8),
                                transition_example(spec), device="cpu")
    u = torch.from_numpy(np.array(jax.random.uniform(key, (32,))))
    tas2, trs2, tm = loop.make_learner_step(tagent, treplay, LoopConfig(batch_size=32))(
        tas, trs, None, u=u)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = interop.agent_state_from_numpy(jax.device_get(jas2))
    for got, ref in zip(tas2.params.parameters(), want.params.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    # the lazy write-back touched the same leaves with the same priorities
    assert trs2.pending == 32 and int(jrs2.pending) == 32
    np.testing.assert_allclose(trs2.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(trs2.max_priority), float(jrs2.max_priority),
                               rtol=1e-5)


def test_counter_histories_match_reference_executor():
    """env_steps / learn_steps / buffer_size do not depend on the random
    streams: 96 iterations (4 full chunks + a tail) with a warmup and a
    learn period must give the reference's histories exactly."""
    kw = dict(batch_size=32, warmup=100, update_interval=16, epsilon=0.3)
    jenv_fn = functools.partial(jmake_vec, "cartpole")
    spec, _, _ = jenv_fn(1)
    jex = jexec.FusedExecutor(
        jmake_dqn(spec, JDQNConfig(hidden=(32, 32))),
        JReplay(JReplayConfig(capacity=256, fanout=8), jexample()),
        jenv_fn, jloop.LoopConfig(**kw), n_envs=4, scan_chunk=20)
    _, jhist = jex.train(96, jax.random.PRNGKey(0))
    ex = executor(LoopConfig(**kw), capacity=256, scan_chunk=20, hidden=(32, 32))
    _, hist = ex.train(96, 0)
    for k in ("env_steps", "learn_steps", "buffer_size"):
        np.testing.assert_array_equal(hist[k].numpy(), np.asarray(jhist[k]), err_msg=k)
    assert int(hist["learn_steps"][-1]) > 0 and int(hist["buffer_size"][-1]) == 256


def test_executor_refuses_async_and_missing_device():
    with pytest.raises(NotImplementedError, match="publish_interval"):
        spec, _, _ = ENV_FN(1)
        replay = PrioritizedReplay(ReplayConfig(capacity=64, fanout=8),
                                   transition_example(spec), device="cpu")
        FusedExecutor(make_dqn(spec, DQNConfig()), replay, ENV_FN, LoopConfig(), 4,
                      publish_interval=2, device="cpu")


def test_full_pipeline_improves_policy():
    """tests/test_system.py's run through the port on the CPU: after 1400
    iterations the policy beats the random baseline (≈ 10)."""
    spec, v_reset, v_step = make_vec("cartpole", 8)
    agent = make_dqn(spec, DQNConfig())
    replay = PrioritizedReplay(ReplayConfig(capacity=20_000, fanout=128),
                               transition_example(spec), device="cpu")
    cfg = LoopConfig(batch_size=64, warmup=400, epsilon=0.2)
    state, hist = loop.train(agent, replay, v_reset, v_step, cfg, n_envs=8,
                             iterations=1400, seed=1)
    final = float(hist["mean_episode_return"][-1])
    assert final > 30.0, final
    assert torch.isfinite(hist["loss"]).all()
    # the run ends with the last iteration's lazy writes still pending
    assert state.replay.pending > 0
    assert tst.check_invariant(replay.spec, replay.flush(state.replay).tree)
