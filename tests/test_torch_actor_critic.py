"""The port's continuous-action learners (repro_torch.agents.ddpg, td3,
sac) against the JAX reference: one learn step from the same state
(JAX → numpy → torch through repro_torch.interop) after two JAX steps, so
that the target differs from the online networks and Adam has moments.

TD3's and SAC's learn-time noise comes from the reference's own keys
(``fold_in(PRNGKey(17 or 23), step)``) and is handed to the port's
``learn(..., noise=...)``.  Tolerance LEARN_TOL (rtol 1e-5, atol 1e-6),
as tests/test_torch_agents.py: f32 matmuls and sums in another order;
the Adam moments rtol 1e-5 / atol 1e-7 (they are ~1e-4 and smaller).
Counters and TD3's untouched target exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents.ddpg import DDPGConfig as JDDPGConfig
from repro.agents.ddpg import make_ddpg as jmake_ddpg
from repro.agents.sac import SACConfig as JSACConfig
from repro.agents.sac import make_sac as jmake_sac
from repro.agents.td3 import TD3Config as JTD3Config
from repro.agents.td3 import make_td3 as jmake_td3
from repro.envs import classic as jenv
from repro_torch import interop
from repro_torch.agents import sac, td3
from repro_torch.agents.base import state_tensors
from repro_torch.agents.ddpg import DDPGConfig, make_ddpg
from repro_torch.envs import classic as tenv

torch.set_num_threads(2)

LEARN_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-5, atol=1e-7)
HIDDEN = (32, 32)
B = 64

AGENTS = {
    "ddpg": (jmake_ddpg, JDDPGConfig(hidden=HIDDEN), make_ddpg, DDPGConfig(hidden=HIDDEN),
             None),
    "td3": (jmake_td3, JTD3Config(hidden=HIDDEN), td3.make_td3, td3.TD3Config(hidden=HIDDEN),
            td3.LEARN_SEED),
    "sac": (jmake_sac, JSACConfig(hidden=HIDDEN), sac.make_sac, sac.SACConfig(hidden=HIDDEN),
            sac.LEARN_SEED),
}


def batch_np(rng, b=B):
    return {"obs": rng.normal(size=(b, 3)).astype(np.float32),
            "action": rng.uniform(-2, 2, (b, 1)).astype(np.float32),
            "reward": rng.uniform(-10, 0, b).astype(np.float32),
            "next_obs": rng.normal(size=(b, 3)).astype(np.float32),
            "done": (rng.uniform(size=b) < 0.2).astype(np.float32)}


def reference_noise(name, step, shape):
    """The reference's learn-time draws at ``step``, as numpy."""
    if name == "td3":
        return np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(17), step), shape))
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(23), step))
    return np.asarray(jax.random.normal(k1, shape)), np.asarray(jax.random.normal(k2, shape))


def to_torch(noise):
    if noise is None:
        return None
    if isinstance(noise, tuple):
        return tuple(torch.from_numpy(np.array(x)) for x in noise)
    return torch.from_numpy(np.array(noise))


def both_steps(name, jagent, jstate, tagent, tstate, rng):
    """One learn step of each side on a new batch → (j out, t out)."""
    batch = batch_np(rng)
    is_w = rng.uniform(0.2, 1.0, B).astype(np.float32)
    step = int(jstate.step)
    kw = {} if name == "ddpg" else {"noise": to_torch(reference_noise(name, step, (B, 1)))}
    jout = jagent.learn(jstate, jax.tree.map(jnp.asarray, batch), jnp.asarray(is_w))
    tout = tagent.learn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.from_numpy(is_w), **kw)
    return jout, tout


def setup(name, jax_steps=2):
    jmake, jcfg, tmake, tcfg, seed = AGENTS[name]
    jagent, tagent = jmake(jenv.PENDULUM, jcfg), tmake(tenv.PENDULUM, tcfg)
    jstate = jagent.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    for _ in range(jax_steps):
        jstate, _, _ = jagent.learn(jstate, jax.tree.map(jnp.asarray, batch_np(rng)),
                                    jnp.ones(B))
    tstate = interop.agent_state_from_numpy(jax.device_get(jstate), generator_seed=seed)
    return jagent, jstate, tagent, tstate, rng, seed


def assert_state_close(name, got, jstate, seed):
    want = state_tensors(interop.agent_state_from_numpy(jax.device_get(jstate),
                                                        generator_seed=seed))
    got = state_tensors(got)
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        if key.endswith("/count") or key == "step":
            assert torch.equal(got[key], ref), key
        elif ref.dtype == torch.uint8:
            continue                   # the learn generator: not the reference's
        elif "/m/" in key or "/v/" in key:
            np.testing.assert_allclose(got[key].numpy(), ref.numpy(), err_msg=key,
                                       **MOMENT_TOL)
        else:
            np.testing.assert_allclose(got[key].detach().numpy(), ref.detach().numpy(),
                                       err_msg=key, **LEARN_TOL)


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_learn_step_matches_reference(name):
    jagent, jstate, tagent, tstate, rng, seed = setup(name)
    (jstate2, jm, jtd), (tstate2, tm, ttd) = both_steps(name, jagent, jstate, tagent,
                                                         tstate, rng)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **LEARN_TOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), **LEARN_TOL)
    assert (ttd >= 0).all()
    assert_state_close(name, tstate2, jstate2, seed)
    assert int(tstate2.step) == int(jstate2.step) == 3
    if name == "sac":
        assert set(tm) == {"loss", "grad_norm", "alpha"}
        # the metric is the old α; log_alpha took its own Adam step
        np.testing.assert_allclose(float(tm["alpha"]), float(np.exp(jstate.extra[0])),
                                   rtol=1e-6)
        assert int(tstate2.extra[1].count) == 3


def test_td3_off_step_keeps_target_and_moves_pi_on_momentum():
    """At step % policy_delay == 1 the actor term is zero: the target tree
    keeps every bit, pi's gradient is zero but Adam still moves pi on its
    momentum, as the reference does."""
    jagent, jstate, tagent, tstate, rng, seed = setup("td3", jax_steps=3)
    assert int(jstate.step) % 2 == 1
    target_before = [p.clone() for p in tstate.target.parameters()]
    pi_before = [p.detach().clone() for p in tstate.params["pi"].parameters()]
    (jstate2, jm, jtd), (tstate2, tm, ttd) = both_steps("td3", jagent, jstate, tagent,
                                                         tstate, rng)
    assert all(torch.equal(a, b) for a, b in zip(target_before, tstate2.target.parameters()))
    assert all(not torch.equal(a, b) for a, b in zip(pi_before, tstate2.params["pi"].parameters()))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LEARN_TOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), **LEARN_TOL)
    assert_state_close("td3", tstate2, jstate2, seed)
    # the reference's target did not move either
    for a, b in zip(jax.tree.leaves(jstate.target), jax.tree.leaves(jstate2.target)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_continuous_agents_learn_step(name):
    """tests/test_agents.py's continuous-agent test on the port: the loss
    falls over 20 steps on a fixed batch, |TD| is finite and ≥ 0, and
    actions have shape (4, 1) and lie in [-2, 2]."""
    _, _, tmake, _, _ = AGENTS[name]
    agent = tmake(tenv.PENDULUM, type(AGENTS[name][3])())
    st = agent.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {
        "obs": torch.from_numpy(rng.normal(size=(32, 3)).astype(np.float32)),
        "action": torch.from_numpy(rng.uniform(-2, 2, (32, 1)).astype(np.float32)),
        "reward": torch.from_numpy(rng.uniform(-10, 0, 32).astype(np.float32)),
        "next_obs": torch.from_numpy(rng.normal(size=(32, 3)).astype(np.float32)),
        "done": torch.zeros(32),
    }
    losses = []
    for _ in range(20):
        st, metrics, td = agent.learn(st, batch, torch.ones(32))
        losses.append(float(metrics["loss"]))
        assert torch.isfinite(td).all() and (td >= 0).all()
    assert losses[-1] < losses[0]
    obs = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    for eps in (0.1, 0.0):
        a = agent.act(st, obs, torch.Generator().manual_seed(1), eps)
        assert a.shape == (4, 1) and a.dtype == torch.float32
        assert (a.abs() <= 2.0 + 1e-5).all()
