"""The paper's system through the port: tests/test_system.py's
checkpoint restart (save mid-training, clobber the state, restore: the
agent comes back bit for bit and training goes on), and a SAC state,
with its log-alpha, that scalar's Adam state and its learn-time
generator, saved and restored so that the next learn step equals the
one taken without the round trip, bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.agents.base import load_generators, state_tensors
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.agents.sac import SACConfig, make_sac
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import PENDULUM, make_vec
from repro_torch.quickstart import transition_example
from repro_torch.runtime import loop

torch.set_num_threads(2)


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().reshape(-1).view(torch.uint8), b.detach().reshape(-1).view(torch.uint8))


def clobber(tensors):
    with torch.no_grad():
        for t in tensors.values():
            t.fill_(float("nan") if t.is_floating_point() else 7)


def test_checkpoint_restart_resumes_exactly(tmp_path):
    spec, v_reset, v_step = make_vec("cartpole", 4)
    agent = make_dqn(spec, DQNConfig())
    replay = PrioritizedReplay(ReplayConfig(capacity=1024, fanout=8),
                               transition_example(spec), device="cpu")
    cfg = loop.LoopConfig(batch_size=32, warmup=64, epsilon=0.2)
    step = loop.make_step(agent, replay, v_step, cfg, 4)
    st = loop.init_loop_state(agent, replay, v_reset, 2, 4)
    for _ in range(30):
        st, _ = step(st)
    assert st.learn_steps > 0
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tensors = state_tensors(st.agent)
    saved = {k: t.detach().clone() for k, t in tensors.items()}
    mgr.save(30, tensors)
    clobber(tensors)
    restored_step, restored = mgr.restore_latest(state_tensors(st.agent))
    assert restored_step == 30
    assert sorted(restored) == sorted(saved)
    assert any(k.startswith("opt/m/") for k in saved) and "step" in saved
    for k, t in restored.items():
        assert same_bits(t, saved[k]), k
    # training continues from the restored state
    st, metrics = step(st)
    assert np.isfinite(float(metrics["loss"]))
    assert int(st.agent.step) == int(saved["step"]) + loop.RatioSchedule.from_config(cfg, 4).learns


def test_sac_state_with_generator_round_trips(tmp_path):
    agent = make_sac(PENDULUM, SACConfig(hidden=(32, 32)))
    st = agent.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)

    def batch():
        return {"obs": torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32)),
                "action": torch.from_numpy(rng.uniform(-2, 2, (16, 1)).astype(np.float32)),
                "reward": torch.from_numpy(rng.uniform(-10, 0, 16).astype(np.float32)),
                "next_obs": torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32)),
                "done": torch.zeros(16)}

    for _ in range(2):
        st, _, _ = agent.learn(st, batch(), torch.ones(16))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tensors = state_tensors(st)
    assert {"extra/0", "extra/1/count", "extra/1/m/0", "extra/1/v/0", "extra/2"} <= set(tensors)
    assert tensors["extra/2"].dtype == torch.uint8
    mgr.save(2, tensors)
    b3 = batch()
    st, m_a, td_a = agent.learn(st, b3, torch.ones(16))        # without the round trip
    after_a = {k: t.detach().clone() for k, t in state_tensors(st).items()}
    clobber({k: t for k, t in state_tensors(st).items() if k != "extra/2"})
    st.extra[2].manual_seed(99)                                 # the stream moved elsewhere
    step, restored = mgr.restore_latest(state_tensors(st))
    load_generators(st, restored)
    assert step == 2 and int(st.step) == 2
    st, m_b, td_b = agent.learn(st, b3, torch.ones(16))        # after it
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a) and torch.equal(td_a, td_b)
    after_b = state_tensors(st)
    assert sorted(after_a) == sorted(after_b)
    for k, t in after_b.items():
        assert same_bits(t, after_a[k]), k


@pytest.mark.parametrize("seed", [0, 5])
def test_state_tensors_are_the_state(seed):
    """``state_tensors`` hands out the state's own tensors (a checkpoint
    restores into them in place), the generator as a copy of its state."""
    agent = make_sac(PENDULUM, SACConfig(hidden=(8,)))
    st = agent.init(torch.Generator().manual_seed(seed))
    tensors = state_tensors(st)
    assert tensors["params/pi.layers.0.weight"] is st.params["pi"].layers[0].weight
    assert tensors["target/q2.layers.1.bias"] is st.target["q2"].layers[1].bias
    assert tensors["extra/0"] is st.extra[0] and tensors["step"] is st.step
    assert torch.equal(tensors["extra/2"], st.extra[2].get_state())
    names = [n for n, _ in st.params.named_parameters()]
    assert names[0].startswith("pi.") and names[-1].startswith("q2.")
    assert len([k for k in tensors if k.startswith("opt/m/")]) == len(names)
