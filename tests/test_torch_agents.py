"""The port's envs, Adam and DQN/DDQN learner against the JAX reference
from identical states (JAX → numpy → torch through repro_torch.interop).

Tolerances: env physics rtol 1e-5 / atol 1e-6 (the two frameworks' sin
and cos differ in the last ulp), done flags exact; one Adam step and one
learn step rtol 1e-5 (f32 matmuls and sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents.dqn import DQNConfig as JDQNConfig
from repro.agents.dqn import make_dqn as jmake_dqn
from repro.envs import classic as jenv
from repro.optim import adam as jadam
from repro_torch import interop
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.envs import classic as tenv
from repro_torch.optim import adam as tadam

torch.set_num_threads(2)

ENV_TOL = dict(rtol=1e-5, atol=1e-6)
LEARN_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.array(x)


def test_cartpole_step_matches_reference():
    rng = np.random.default_rng(0)
    n = 64
    x = rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
    x[:8, 0] = 2.39                         # about to leave the track
    t = rng.integers(0, 500, n).astype(np.int32)
    t[8:12] = 499                           # about to time out
    a = rng.integers(0, 2, n).astype(np.int32)
    js, jobs, jrew, jdone = jax.vmap(jenv.cartpole_step)(
        jenv.EnvState(jnp.asarray(x), jnp.asarray(t)), jnp.asarray(a),
        jax.random.split(jax.random.PRNGKey(0), n))
    ts = interop.env_state_from_numpy(jenv.EnvState(x, t))
    ts2, tobs, trew, tdone = tenv.cartpole_step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(tobs.numpy(), _np(jobs), **ENV_TOL)
    np.testing.assert_allclose(ts2.x.numpy(), _np(js.x), **ENV_TOL)
    np.testing.assert_array_equal(ts2.t.numpy(), _np(js.t))
    np.testing.assert_array_equal(tdone.numpy(), _np(jdone))
    np.testing.assert_array_equal(trew.numpy(), _np(jrew))
    assert tdone.any() and not tdone.all()


def test_pendulum_step_matches_reference():
    rng = np.random.default_rng(1)
    n = 64
    x = np.stack([rng.uniform(-7, 7, n), rng.uniform(-9, 9, n)], -1).astype(np.float32)
    t = rng.integers(190, 200, n).astype(np.int32)
    a = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    js, jobs, jrew, jdone = jax.vmap(jenv.pendulum_step)(
        jenv.EnvState(jnp.asarray(x), jnp.asarray(t)), jnp.asarray(a),
        jax.random.split(jax.random.PRNGKey(0), n))
    ts2, tobs, trew, tdone = tenv.pendulum_step(
        interop.env_state_from_numpy(jenv.EnvState(x, t)), torch.from_numpy(a))
    np.testing.assert_allclose(tobs.numpy(), _np(jobs), **ENV_TOL)
    np.testing.assert_allclose(trew.numpy(), _np(jrew), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts2.x.numpy(), _np(js.x), **ENV_TOL)
    np.testing.assert_array_equal(tdone.numpy(), _np(jdone))


def test_vec_env_auto_reset_returns_true_next_obs():
    spec, v_reset, v_step = tenv.make_vec("cartpole", 16)
    gen = torch.Generator().manual_seed(0)
    st, obs = v_reset(gen)
    assert obs.shape == (16, 4) and (obs.abs() <= 0.05).all()
    st = st._replace(x=st.x.clone(), t=st.t.clone())
    st.x[:4, 0] = 2.39
    st.x[:4, 1] = 5.0                       # these four leave the track now
    pre, _, _, _ = tenv.cartpole_step(st, torch.ones(16, dtype=torch.int64))
    st2, obs_out, rew, done, true_next = v_step(st, torch.ones(16, dtype=torch.int64), gen)
    assert done[:4].all() and not done[4:].any()
    torch.testing.assert_close(true_next, pre.x)      # pre-reset next obs
    assert (obs_out[:4].abs() <= 0.05).all()           # reset obs for done envs
    torch.testing.assert_close(obs_out[4:], pre.x[4:])
    assert (st2.t[:4] == 0).all() and (st2.t[4:] == st.t[4:] + 1).all()


def _params_np(rng, sizes):
    return [{"w": rng.normal(size=(a, b)).astype(np.float32) * 0.3,
             "b": rng.normal(size=(b,)).astype(np.float32) * 0.1}
            for a, b in zip(sizes[:-1], sizes[1:])]


def test_adam_step_matches_reference():
    rng = np.random.default_rng(2)
    params = _params_np(rng, (4, 16, 2))
    grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32),
                         params)
    cfg = jadam.AdamConfig(lr=1e-2, weight_decay=0.01)
    jstate = jadam.init(params, cfg)
    jstate = jstate._replace(count=jnp.asarray(4, jnp.int32))
    jp, jstate2, jnorm = jadam.update(grads, jstate, params, cfg)

    net = interop.mlp_from_numpy(params)
    tgrads = [torch.from_numpy(g) for g in interop.flatten_mlp(grads)]
    tstate = tadam.init(net.parameters(), tadam.AdamConfig(lr=1e-2, weight_decay=0.01))
    tstate = tstate._replace(count=torch.tensor(4, dtype=torch.int32))
    tstate2, tnorm = tadam.update(tgrads, tstate, list(net.parameters()),
                                  tadam.AdamConfig(lr=1e-2, weight_decay=0.01))
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    assert float(jnorm) > 1.0               # the clip really engaged
    for got, want in zip(net.parameters(), interop.flatten_mlp(jax.device_get(jp))):
        np.testing.assert_allclose(got.detach().numpy(), want, **LEARN_TOL)
    for got, want in zip(tstate2.m, interop.flatten_mlp(jax.device_get(jstate2.m))):
        np.testing.assert_allclose(got.numpy(), want, **LEARN_TOL)
    for got, want in zip(tstate2.v, interop.flatten_mlp(jax.device_get(jstate2.v))):
        np.testing.assert_allclose(got.numpy(), want, **LEARN_TOL)
    assert int(tstate2.count) == int(jstate2.count) == 5


@pytest.mark.parametrize("double_q", [False, True])
def test_learn_step_matches_reference(double_q):
    spec = jenv.CARTPOLE
    jagent = jmake_dqn(spec, JDQNConfig(double_q=double_q))
    tagent = make_dqn(tenv.CARTPOLE, DQNConfig(double_q=double_q))
    jstate = jagent.init(jax.random.PRNGKey(3))
    # two learn steps in JAX first, so target ≠ params and Adam has moments
    rng = np.random.default_rng(4)

    def batch_np(b=64):
        return {"obs": rng.normal(size=(b, 4)).astype(np.float32),
                "action": rng.integers(0, 2, b).astype(np.int32),
                "reward": np.ones(b, np.float32),
                "next_obs": rng.normal(size=(b, 4)).astype(np.float32),
                "done": (rng.uniform(size=b) < 0.2).astype(np.float32)}

    for _ in range(2):
        jstate, _, _ = jagent.learn(jstate, jax.tree.map(jnp.asarray, batch_np()),
                                    jnp.ones(64))
    tstate = interop.agent_state_from_numpy(jax.device_get(jstate))
    batch = batch_np()
    is_w = rng.uniform(0.2, 1.0, 64).astype(np.float32)
    jstate2, jm, jtd = jagent.learn(jstate, jax.tree.map(jnp.asarray, batch),
                                    jnp.asarray(is_w))
    tstate2, tm, ttd = tagent.learn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    torch.from_numpy(is_w))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LEARN_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **LEARN_TOL)
    np.testing.assert_allclose(ttd.numpy(), _np(jtd), **LEARN_TOL)
    want = interop.agent_state_from_numpy(jax.device_get(jstate2))
    for net in ("params", "target"):
        for got, ref in zip(getattr(tstate2, net).parameters(),
                            getattr(want, net).parameters()):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                       **LEARN_TOL)
    for got, ref in zip(tstate2.opt.m + tstate2.opt.v, want.opt.m + want.opt.v):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-7)
    assert int(tstate2.opt.count) == int(want.opt.count) == 3
    assert int(tstate2.step) == int(want.step) == 3


def test_act_greedy_ties_take_first_action():
    agent = make_dqn(tenv.CARTPOLE, DQNConfig(hidden=(8,)))
    st = agent.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in st.params.parameters():
            p.zero_()                       # every Q-value ties at 0
    a = agent.act(st, torch.zeros(32, 4), torch.Generator().manual_seed(1), 0.0)
    assert (a == 0).all()                   # jnp.argmax's first-max rule
    a = agent.act(st, torch.zeros(4096, 4), torch.Generator().manual_seed(1), 1.0)
    assert 0.4 < a.float().mean() < 0.6     # ε = 1: uniform random actions
