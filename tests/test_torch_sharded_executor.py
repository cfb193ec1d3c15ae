"""The port's sharded runtime (repro_torch.runtime.executors.ShardedExecutor,
AsyncExecutor on a mesh, runtime.learner, checkpoint.elastic, the
quickstart's sharding flags) — ports of tests/test_executors.py:136-243,
tests/test_async_executor.py's sharded test, tests/test_pod_executor.py and
tests/test_distributed.py's executor test.

Each world is a set of gloo ranks on the CPU spawned once for the module
(launch/mesh.py::spawn): 2 ranks, then 1, then 4, chained by the elastic
checkpoints (written at world 2, restored at world 1; written there,
restored at world 4).  The rank functions live in this module and the
ranks import it, so JAX is imported inside the tests.

Tolerances: the port's equivalences bit for bit — 1 shard ≡ fused,
1×1 pod×data ≡ fused, 2×1 pod×data ≡ 2 shards, the async executor at
publish interval 1 / max staleness 0 ≡ the synchronous sharded one, the
replicated state across ranks, the elastic restore; one learner call on
the carried-over state against the reference's ``make_sharded_learn``
under ``jax.vmap``: loss, parameters and tree at rtol 1e-5 / atol 1e-6 (f32
matmuls in another order, as tests/test_torch_loop.py), the compressed
call's EF buffer within one quantization step (a q may differ by 1).
Whole runs are held to the reference's bars (JAX's and torch's random
streams differ).
"""

import functools
import math
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.agents.base import state_tensors
from repro_torch.agents.ddpg import DDPGConfig, make_ddpg
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.checkpoint import elastic
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.distributed import ShardedPrioritizedReplay, ShardedReplayConfig
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig, ReplayState
from repro_torch.envs.classic import make_vec
from repro_torch.launch import mesh as meshlib
from repro_torch.optim import compress
from repro_torch.quickstart import transition_example
from repro_torch.runtime import loop
from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor, ShardedExecutor
from repro_torch.runtime.learner import make_sharded_learn
from repro_torch.runtime.loop import LoopConfig

CARTPOLE = functools.partial(make_vec, "cartpole")
PENDULUM = functools.partial(make_vec, "pendulum")
LEARN_TOL = dict(rtol=1e-5, atol=1e-6)
PARITY_HIDDEN = (32, 32)
SMALL = LoopConfig(batch_size=32, warmup=8, epsilon=0.2)


def _dqn(hidden=(256, 256)):
    spec, _, _ = CARTPOLE(1)
    return spec, make_dqn(spec, DQNConfig(hidden=hidden))


def _fused(agent, spec, cfg, n_envs, env_fn=CARTPOLE, capacity=1024, scan_chunk=16):
    replay = PrioritizedReplay(ReplayConfig(capacity=capacity, fanout=8),
                               transition_example(spec), device="cpu")
    return FusedExecutor(agent, replay, env_fn, cfg, n_envs, scan_chunk=scan_chunk, device="cpu")


def _srb(spec, axes, capacity=1024):
    return ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=capacity, fanout=8, axis_names=axes),
        transition_example(spec), device="cpu")


def _sharded(agent, spec, cfg, n_envs, mesh, env_fn=CARTPOLE, capacity=1024, scan_chunk=16,
             **kw):
    return ShardedExecutor(agent, _srb(spec, mesh.axis_names, capacity), env_fn, cfg, n_envs,
                           mesh, scan_chunk=scan_chunk, device="cpu", **kw)


def _differing(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]


def _snapshot(agent_state) -> dict:
    return {k: t.detach().clone() for k, t in state_tensors(agent_state).items()}


# -- the reference's learner call, carried across --------------------------------


def _parity_inputs(axes, n_cells, batch_per_shard):
    """The reference's agent and replay shards, one learner call of its
    ``make_sharded_learn`` under vmap, and the inputs the ranks need to
    repeat it (npz-ready arrays) → (arrays, reference outputs)."""
    import jax
    import jax.numpy as jnp

    from repro.agents.dqn import DQNConfig as JDQNConfig
    from repro.agents.dqn import make_dqn as jmake_dqn
    from repro.core.distributed import ShardedPrioritizedReplay as JSharded
    from repro.core.distributed import ShardedReplayConfig as JConfig
    from repro.envs.classic import make_vec as jmake_vec
    from repro.optim import compress as jc
    from repro.runtime.learner import make_sharded_learn as jlearn
    from repro_torch import interop
    spec, _, _ = jmake_vec("cartpole", 1)
    jagent = jmake_dqn(spec, JDQNConfig(hidden=PARITY_HIDDEN, double_q=True))
    jrb = JSharded(JConfig(capacity_per_shard=256, fanout=8, axis_names=axes),
                   {"obs": jnp.zeros((4,), jnp.float32), "action": jnp.zeros((), jnp.int32),
                    "reward": jnp.zeros(()), "next_obs": jnp.zeros((4,), jnp.float32),
                    "done": jnp.zeros(())})
    rng = np.random.default_rng(len(axes))
    states = []
    for _ in range(n_cells):
        n = 200
        data = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                "action": rng.integers(0, 2, n).astype(np.int32),
                "reward": np.ones(n, np.float32),
                "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
                "done": (rng.uniform(size=n) < 0.1).astype(np.float32)}
        st = jrb.insert(jrb.init(), jax.tree.map(jnp.asarray, data))
        st = jrb.update_priorities(st, jnp.arange(n),
                                   jnp.asarray(rng.uniform(0, 2, n).astype(np.float32)))
        states.append(st)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    jas = jagent.init(jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(9), n_cells)
    compress_axis = axes[0] if len(axes) > 1 else None
    learn = jlearn(jagent, jrb, batch_per_shard, 0.4, compress_axis=compress_axis)
    ef0 = jc.init_error(jas.params) if compress_axis else ()

    def one(rstate, key):
        a, r, m, ef = learn(jas, rstate, key, ef=ef0)
        return a.params, r.tree, m["loss"], ef

    if len(axes) == 1:
        out = jax.jit(jax.vmap(one, axis_name=axes[0]))(stacked, keys)
    else:
        shaped = jax.tree.map(lambda x: x.reshape((2, 2) + x.shape[1:]), stacked)
        out = jax.jit(jax.vmap(jax.vmap(one, axis_name=axes[1]), axis_name=axes[0]))(
            shaped, keys.reshape(2, 2, -1))
        out = jax.tree.map(lambda x: x.reshape((4,) + x.shape[2:]), out)
    params, tree, loss, ef = jax.device_get(out)
    arrays = {"tree": np.asarray(stacked.tree), "count": np.asarray(stacked.count),
              "u": np.stack([np.asarray(jax.random.uniform(k, (batch_per_shard,)))
                             for k in keys])}
    arrays.update({f"storage/{k}": np.asarray(v) for k, v in stacked.storage.items()})
    for i, x in enumerate(interop.param_leaves_from_numpy(jax.device_get(jas.params))):
        arrays[f"params/{i}"] = x.numpy()
    want = {"loss": np.asarray(loss), "tree": np.asarray(tree),
            "params": [[p.numpy() for p in interop.param_leaves_from_numpy(
                jax.tree.map(lambda x: x[c], params))] for c in range(n_cells)],
            "ef": ([[p.numpy() for p in interop.param_leaves_from_numpy(
                jax.tree.map(lambda x: x[c], ef))] for c in range(n_cells)]
                   if compress_axis else None)}
    return arrays, want


def _port_learner_call(path, mesh, batch_per_shard):
    """The ranks' side of ``_parity_inputs``: the same call on this shard."""
    with np.load(path) as f:
        arrays = dict(f)
    sid = mesh.shard_id
    spec, _, _ = CARTPOLE(1)
    agent = make_dqn(spec, DQNConfig(hidden=PARITY_HIDDEN, double_q=True))
    st = agent.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p, t in zip(list(st.params.parameters()) + list(st.target.parameters()),
                        [arrays[f"params/{i}"] for i in range(6)] * 2):
            p.copy_(torch.from_numpy(t))
    srb = ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=256, fanout=8, axis_names=mesh.axis_names),
        transition_example(spec), device="cpu")
    rstate = ReplayState(tree=torch.from_numpy(arrays["tree"][sid].copy()),
                         storage={k[len("storage/"):]: torch.from_numpy(v[sid].copy())
                                  for k, v in arrays.items() if k.startswith("storage/")},
                         head=int(arrays["count"][sid]), count=int(arrays["count"][sid]),
                         max_priority=torch.tensor(1.0))
    compress_axis = mesh.axis_names[0] if len(mesh.axis_names) > 1 else None
    learn = make_sharded_learn(agent, srb, batch_per_shard, mesh, beta=0.4,
                               compress_axis=compress_axis)
    ef0 = compress.init_error(list(st.params.parameters())) if compress_axis else None
    st, rstate, m, ef = learn(st, rstate, None, ef=ef0,
                              u=torch.from_numpy(arrays["u"][sid].copy()))
    return {"loss": float(m["loss"]), "tree": rstate.tree.numpy(),
            "params": [p.detach().numpy().copy() for p in st.params.parameters()],
            "ef": [e.numpy() for e in ef] if ef else None}


# -- elastic ---------------------------------------------------------------------


def _elastic(mesh, ckpt_in, ckpt_out, seed):
    """Restore the learner state written at another world size, check it
    bit for bit against the writer's copy, refill the replay and take a
    learning step; then write this world's state for the next."""
    spec, agent = _dqn()
    cfg = LoopConfig(batch_size=32, warmup=64, epsilon=0.2)
    ex = _sharded(agent, spec, cfg, 4, mesh)
    st = ex.init(seed)
    step = elastic.restore_learner(CheckpointManager(ckpt_in), st.agent)
    want = torch.load(os.path.join(ckpt_in, "ref.pt"))
    out = {"step": step, "differing": _differing(state_tensors(st.agent), want)}
    while st.learn_steps == 0:
        st, metrics = ex.step(st)
    out["loss"] = float(metrics["loss"])
    out["iterations"] = st.env_steps // 4
    if ckpt_out:
        _save(st.agent, ckpt_out, step + 1)
    return out


def _save(agent_state, directory, step):
    elastic.save_learner(CheckpointManager(directory), step, agent_state)
    if torch.distributed.get_rank() == 0:
        torch.save(_snapshot(agent_state), os.path.join(directory, "ref.pt"))


# -- the worlds ------------------------------------------------------------------


def _world2_rank(rank, parity_path, ckpt_out):
    torch.set_num_threads(1)
    spec, agent = _dqn()
    out = {}
    for name, mesh in (("data", meshlib.data_mesh(2)), ("pod_data", meshlib.pod_data_mesh(2, 1))):
        st, hist = _sharded(agent, spec, SMALL, 8, mesh).train(40, 7)
        out[name] = {"hist": hist, "state": _snapshot(st.agent)}
        if name == "data":
            _save(st.agent, ckpt_out, 40)
    # the long horizon at ε = 1 (tests/test_pod_executor.py): the actions are
    # random, so the collection cannot fork while every iteration learns
    cfg = LoopConfig(batch_size=32, warmup=64, epsilon=1.0, epsilon_final=1.0)
    for name, mesh in (("data_long", meshlib.data_mesh(2)),
                       ("pod_data_long", meshlib.pod_data_mesh(2, 1))):
        st, hist = _sharded(agent, spec, cfg, 8, mesh).train(80, 7)
        out[name] = {"hist": hist, "state": _snapshot(st.agent)}
    # DDPG: the parameter-average fallback
    pspec, _, _ = PENDULUM(1)
    ddpg = make_ddpg(pspec, DDPGConfig(hidden=(32, 32)))
    st, hist = _sharded(ddpg, pspec, LoopConfig(batch_size=32, warmup=16, epsilon=0.1), 8,
                        meshlib.data_mesh(2), env_fn=PENDULUM, scan_chunk=4).train(12, 3)
    out["ddpg"] = {"hist": hist, "state": _snapshot(st.agent), "learn_steps": st.learn_steps}
    out["parity"] = _port_learner_call(parity_path, meshlib.data_mesh(2), 16)
    return out


def _world1_rank(rank, ckpt_in, ckpt_out):
    torch.set_num_threads(1)
    spec, agent = _dqn()
    out = {}
    s1, h1 = _fused(agent, spec, SMALL, 4).train(40, 7)
    for name, mesh in (("data", meshlib.data_mesh(1)), ("pod_data", meshlib.pod_data_mesh(1, 1))):
        s2, h2 = _sharded(agent, spec, SMALL, 4, mesh).train(40, 7)
        out[name] = {"metrics": _differing(h1, h2),
                     "state": _differing(state_tensors(s1.agent), state_tensors(s2.agent)),
                     "learn_steps": s2.learn_steps, "keys": sorted(h2)}
    # long horizon at ε = 1 (tests/test_executors.py)
    cfg = LoopConfig(batch_size=32, warmup=64, epsilon=1.0, epsilon_final=1.0)
    s1, h1 = _fused(agent, spec, cfg, 16).train(80, 7)
    s2, h2 = _sharded(agent, spec, cfg, 16, meshlib.data_mesh(1)).train(80, 7)
    out["long"] = {"metrics": _differing(h1, h2),
                   "state": _differing(state_tensors(s1.agent), state_tensors(s2.agent))}
    # the 1×1 compressed reduce threads a live EF buffer
    pd = meshlib.pod_data_mesh(1, 1)
    st, hist = _sharded(agent, spec, SMALL, 4, pd, scan_chunk=4,
                        compress_pod_reduce=True).train(24, 3)
    out["compressed"] = {"loss": hist["loss"], "ef_max": [float(e.abs().max()) for e in st.ef_error],
                         "ef_leaves": len(st.ef_error),
                         "plain_ef": _sharded(agent, spec, SMALL, 4, pd).init(0).ef_error}
    # bf16 on the intra-pod wire: the error norm metric (tests/test_distributed.py)
    for dtype in ("bf16", None):
        _, hist = _sharded(agent, spec, SMALL, 4, meshlib.data_mesh(1), scan_chunk=8,
                           intra_pod_dtype=dtype).train(24, 0)
        out[f"err_norm/{dtype}"] = hist["compress_error_norm"]
    # DDPG's fallback at one shard is its fused loop
    pspec, _, _ = PENDULUM(1)
    ddpg = make_ddpg(pspec, DDPGConfig(hidden=(32, 32)))
    pcfg = LoopConfig(batch_size=32, warmup=16, epsilon=0.1)
    s1, h1 = _fused(ddpg, pspec, pcfg, 4, env_fn=PENDULUM, scan_chunk=4).train(12, 3)
    s2, h2 = _sharded(ddpg, pspec, pcfg, 4, meshlib.data_mesh(1), env_fn=PENDULUM,
                      scan_chunk=4).train(12, 3)
    out["ddpg"] = {"metrics": _differing(h1, h2), "learn_steps": s2.learn_steps,
                   "state": _differing(state_tensors(s1.agent), state_tensors(s2.agent))}
    out["elastic"] = _elastic(meshlib.data_mesh(1), ckpt_in, ckpt_out, seed=11)
    return out


def _world4_rank(rank, parity_path, ckpt_in):
    torch.set_num_threads(1)
    spec, agent = _dqn()
    out = {}
    d4 = meshlib.data_mesh(4)
    # tests/test_executors.py's SHARDED_E2E
    cfg = LoopConfig(batch_size=64, warmup=128, epsilon=0.2, update_interval=8)
    ex = _sharded(agent, spec, cfg, 8, d4, capacity=2048)
    st, hist = ex.train(192, 0)
    out["e2e"] = {"hist": hist, "n_envs_local": ex.n_envs_local,
                  "finite": all(bool(torch.isfinite(p).all()) for p in st.agent.params.parameters()),
                  "state": _snapshot(st.agent)}
    # tests/test_async_executor.py's sharded test: identity settings, then
    # bounded staleness on staggered clocks
    acfg = LoopConfig(batch_size=64, warmup=32, epsilon=0.2)
    s1, h1 = _sharded(agent, spec, acfg, 8, d4, scan_chunk=4).train(12, 5)
    ident = AsyncExecutor(agent, _srb(spec, ("data",)), CARTPOLE, acfg, 8, publish_interval=1,
                          max_staleness=0, mesh=d4, scan_chunk=4, device="cpu")
    s2, h2 = ident.train(12, 5)
    out["async_identity"] = {"metrics": _differing(h1, h2),
                             "state": _differing(state_tensors(s1.agent), state_tensors(s2.agent))}
    ex = AsyncExecutor(agent, _srb(spec, ("data",)), CARTPOLE, acfg, 8, publish_interval=4,
                       max_staleness=1, mesh=d4, scan_chunk=8, device="cpu")
    st, hist = ex.train(96, 5)
    out["async"] = {"age": st.params_age, "hist": hist, "state": _snapshot(st.agent)}
    # tests/test_pod_executor.py: the 2×2 compressed path end to end, then
    # compressed against uncompressed over a short window
    pd = meshlib.pod_data_mesh(2, 2)
    ex = _sharded(agent, spec, cfg, 8, pd, capacity=2048, compress_pod_reduce=True)
    st, hist = ex.train(192, 0)
    comp, _ = compress.compress(list(st.agent.params.parameters()),
                                compress.init_error(list(st.agent.params.parameters())))
    out["pod_e2e"] = {"hist": hist, "n_shards": ex.n_shards, "state": _snapshot(st.agent),
                      "payload": compress.payload_bytes(comp),
                      "raw": compress.raw_bytes(list(st.agent.params.parameters())),
                      "q_dtypes": {str(c.q.dtype) for c in comp}}
    su, hu = _sharded(agent, spec, SMALL, 8, pd, scan_chunk=4).train(12, 7)
    sc, hc = _sharded(agent, spec, SMALL, 8, pd, scan_chunk=4,
                      compress_pod_reduce=True).train(12, 7)
    out["compress_vs_plain"] = {
        "counters": [k for k in ("env_steps", "learn_steps", "buffer_size")
                     if not torch.equal(hu[k], hc[k])],
        "finite": bool(torch.isfinite(hc["loss"]).all()),
        "max_param_diff": max(float((a - b).detach().abs().max()) for a, b in
                              zip(su.agent.params.parameters(), sc.agent.params.parameters()))}
    st, hist = _sharded(agent, spec, SMALL, 8, pd, scan_chunk=8, compress_pod_reduce=True,
                        overlap_pod_reduce=True).train(24, 7)
    out["overlap"] = {"loss": hist["loss"], "keys": sorted(st.ef_error),
                      "moved": float(compress.l2_norm(st.ef_error["prev_mean"])),
                      "state": _snapshot(st.agent)}
    out["parity"] = _port_learner_call(parity_path, pd, 8)
    out["elastic"] = _elastic(d4, ckpt_in, None, seed=13)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_executor")
    ckpt2, ckpt1 = str(root / "ckpt_world2"), str(root / "ckpt_world1")
    os.makedirs(ckpt2)
    os.makedirs(ckpt1)
    want = {}
    for name, axes, cells, bps in (("w2", ("data",), 2, 16), ("w4", ("pod", "data"), 4, 8)):
        arrays, want[name] = _parity_inputs(axes, cells, bps)
        np.savez(root / f"parity_{name}.npz", **arrays)
    spawn = functools.partial(meshlib.spawn, backend="gloo", device="cpu", timeout_s=600)
    w2 = spawn(_world2_rank, 2, str(root / "parity_w2.npz"), ckpt2)
    w1 = spawn(_world1_rank, 1, ckpt2, ckpt1)
    w4 = spawn(_world4_rank, 4, str(root / "parity_w4.npz"), ckpt1)
    return {"w1": w1, "w2": w2, "w4": w4, "want": want}


# -- in-process: keys and validation ----------------------------------------------


def test_metric_keys_match_reference():
    from repro.runtime import loop as jloop
    assert loop.METRIC_KEYS == jloop.METRIC_KEYS
    assert loop.LEARN_METRIC_KEYS == jloop.LEARN_METRIC_KEYS
    spec, agent = _dqn((8,))
    _, hist = _fused(agent, spec, SMALL, 4, scan_chunk=4).train(8, 0)
    assert tuple(hist) == loop.METRIC_KEYS
    assert (hist["compress_error_norm"] == 0.0).all()
    _, hist = AsyncExecutor(agent, _fused(agent, spec, SMALL, 4).replay, CARTPOLE, SMALL, 4,
                            publish_interval=2, scan_chunk=4, device="cpu").train(8, 0)
    assert tuple(hist) == loop.METRIC_KEYS and (hist["compress_error_norm"] == 0.0).all()


def test_executor_validation_matches_reference():
    """The reference's refusals, on shape-only meshes (no process group)."""
    spec, agent = _dqn((8,))
    d1, pd = meshlib.Mesh(("data",), (1,)), meshlib.Mesh(("pod", "data"), (1, 1))
    cfg = LoopConfig(batch_size=32)
    with pytest.raises(ValueError, match="axis_names"):
        ShardedExecutor(agent, _srb(spec, ("data",)), CARTPOLE, cfg, 4, pd, device="cpu")
    with pytest.raises(ValueError, match="not in mesh axes"):
        ShardedExecutor(agent, _srb(spec, ("pod", "data")), CARTPOLE, cfg, 4, d1, device="cpu")
    with pytest.raises(ValueError, match="multi-axis"):
        ShardedExecutor(agent, _srb(spec, ("data",)), CARTPOLE, cfg, 4, d1,
                        compress_pod_reduce=True, device="cpu")
    with pytest.raises(ValueError, match="overlap_pod_reduce needs compress_pod_reduce"):
        ShardedExecutor(agent, _srb(spec, ("pod", "data")), CARTPOLE, cfg, 4, pd,
                        overlap_pod_reduce=True, device="cpu")
    d4 = meshlib.Mesh(("data",), (4,))
    with pytest.raises(ValueError, match="n_envs=6 not divisible"):
        ShardedExecutor(agent, _srb(spec, ("data",)), CARTPOLE, cfg, 6, d4, device="cpu")
    with pytest.raises(ValueError, match="batch_size=30 not divisible"):
        ShardedExecutor(agent, _srb(spec, ("data",)), CARTPOLE, LoopConfig(batch_size=30), 8,
                        d4, device="cpu")
    # the aliasing guard: shards permanently dropped from the reduce
    with pytest.raises(ValueError, match="permanently dropped"):
        AsyncExecutor(agent, _srb(spec, ("data",)), CARTPOLE,
                      LoopConfig(batch_size=64, update_interval=32), 8, publish_interval=4,
                      max_staleness=0, mesh=d4, device="cpu")
    replay = _fused(agent, spec, cfg, 4).replay
    for kw, msg in ((dict(publish_interval=0), "publish_interval"),
                    (dict(max_staleness=-1), "max_staleness"),
                    (dict(overlap_pod_reduce=True, max_staleness=1), "incompatible"),
                    (dict(compress_pod_reduce=True), "mesh"),
                    (dict(overlap_pod_reduce=True), "mesh"),
                    (dict(intra_pod_dtype="bf16"), "mesh")):
        with pytest.raises(ValueError, match=msg):
            AsyncExecutor(agent, replay, CARTPOLE, cfg, 4, device="cpu", **kw)
    with pytest.raises(ValueError, match="overlap_pod_reduce is incompatible"):
        ShardedExecutor(agent, _srb(spec, ("pod", "data")), CARTPOLE, cfg, 4, pd,
                        publish_interval=2, max_staleness=1, compress_pod_reduce=True,
                        overlap_pod_reduce=True, device="cpu")
    # the parameter-average fallback has no gradient to quantize or cast
    pspec, _, _ = PENDULUM(1)
    ddpg = make_ddpg(pspec, DDPGConfig(hidden=(8,)))
    for kw in (dict(compress_axis="pod"), dict(intra_pod_dtype="bf16")):
        with pytest.raises(ValueError, match="no grads/apply_grads split"):
            make_sharded_learn(ddpg, _srb(pspec, ("pod", "data")), 8, pd, **kw)


def test_mesh_shape_and_lines():
    m = meshlib.Mesh(("pod", "data"), (2, 3), rank=4)
    assert m.coords == {"pod": 1, "data": 1} and m.shard_id == 4 and m.n_shards == 6
    assert m.axis_index("data") == 1 and m.axis_size("pod") == 2
    assert meshlib._lines((2, 3), 0) == [[0, 3], [1, 4], [2, 5]]
    assert meshlib._lines((2, 3), 1) == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="both axis extents"):
        meshlib.pod_data_mesh(0, 2)
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.data_mesh(2)
    with pytest.raises(ValueError, match="backend"):
        meshlib.spawn(print, 1, backend="mpi", device="cpu")


def test_spawn_fails_when_a_rank_raises():
    """One rank's exception raises here with its traceback and ends the
    other rank, which would otherwise sleep for two minutes."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        meshlib.spawn(_fail_on_rank_one, 2, backend="gloo", device="cpu", timeout_s=300)
    assert time.monotonic() - t0 < 60


def _fail_on_rank_one(rank):
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    time.sleep(120)


def test_shard_seed():
    assert loop.shard_seed(7, 0) == 7
    assert len({loop.shard_seed(7, d) for d in range(1, 9)} | {7}) == 9
    assert loop.shard_seed(7, 3) == loop.shard_seed(7, 3) != loop.shard_seed(8, 3)


# -- world 1 -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["data", "pod_data"])
def test_one_shard_reproduces_fused_bit_for_bit(worlds, name):
    r = worlds["w1"][0][name]
    assert r["keys"] == sorted(loop.METRIC_KEYS)
    assert not r["metrics"] and not r["state"] and r["learn_steps"] > 0, r


def test_one_shard_long_horizon_bit_for_bit(worlds):
    r = worlds["w1"][0]["long"]
    assert not r["metrics"] and not r["state"], r


def test_1x1_compressed_reduce_threads_ef_state(worlds):
    r = worlds["w1"][0]["compressed"]
    assert torch.isfinite(r["loss"]).all()
    assert r["ef_leaves"] == 6 and max(r["ef_max"]) > 0
    assert r["plain_ef"] is None


def test_bf16_intra_pod_surfaces_error_norm_metric(worlds):
    r = worlds["w1"][0]
    assert float(r["err_norm/bf16"][-1]) > 0.0
    assert (r["err_norm/None"] == 0.0).all()


def test_ddpg_parameter_average_at_one_shard_is_fused(worlds):
    r = worlds["w1"][0]["ddpg"]
    assert not r["metrics"] and not r["state"] and r["learn_steps"] > 0, r


# -- world 2 -----------------------------------------------------------------------


@pytest.mark.parametrize("horizon", ["", "_long"])
def test_2x1_pod_data_reproduces_two_shards_bit_for_bit(worlds, horizon):
    for r in worlds["w2"]:
        a, b = r["data" + horizon], r["pod_data" + horizon]
        assert not _differing(a["hist"], b["hist"])
        assert not _differing(a["state"], b["state"])
        assert int(a["hist"]["learn_steps"][-1]) > 0
        assert int(a["hist"]["buffer_size"][-1]) == (640 if horizon else 320)


@pytest.mark.parametrize("world,key", [("w2", "data"), ("w2", "ddpg"), ("w4", "e2e"),
                                       ("w4", "async"), ("w4", "pod_e2e")])
def test_replicated_state_identical_across_ranks(worlds, world, key):
    ranks = worlds[world]
    for r in ranks[1:]:
        assert not _differing(ranks[0][key]["state"], r[key]["state"]), (world, key)
        for k in ("loss", "mean_episode_return", "buffer_size"):
            if "hist" in r[key]:
                assert torch.equal(ranks[0][key]["hist"][k], r[key]["hist"][k]), k


def test_ddpg_two_shards_parameter_average(worlds):
    for r in worlds["w2"]:
        d = r["ddpg"]
        assert d["learn_steps"] > 0 and torch.isfinite(d["hist"]["loss"]).all()
        assert all(torch.isfinite(t).all() for t in d["state"].values())


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_sharded_learner_call_matches_reference(worlds, world):
    want = worlds["want"][world]
    for sid, r in enumerate(worlds[world]):
        got = r["parity"]
        np.testing.assert_allclose(got["loss"], want["loss"][sid], **LEARN_TOL)
        np.testing.assert_allclose(got["tree"], want["tree"][sid], **LEARN_TOL)
        for a, b in zip(got["params"], want["params"][sid]):
            np.testing.assert_allclose(a, b, **LEARN_TOL)
        if want["ef"] is not None:
            for a, b in zip(got["ef"], want["ef"][sid]):
                step = max(float(np.abs(b).max()), 1e-12) * 2 / 127.0
                np.testing.assert_allclose(a, b, rtol=0, atol=max(step, 1e-6))


# -- world 4 -----------------------------------------------------------------------


def test_sharded_executor_e2e(worlds):
    for r in worlds["w4"]:
        hist = r["e2e"]["hist"]
        env_steps, learns = int(hist["env_steps"][-1]), int(hist["learn_steps"][-1])
        assert r["e2e"]["n_envs_local"] == 2 and env_steps == 192 * 8 and learns > 0
        assert abs((env_steps - 128) / learns - 8.0) <= 1.0
        assert int(hist["buffer_size"][-1]) == 192 * 8
        assert torch.isfinite(hist["loss"]).all() and r["e2e"]["finite"]
        assert float(hist["mean_episode_return"][-1]) > 0.0


def test_async_identity_reproduces_sync_sharded_bit_for_bit(worlds):
    for r in worlds["w4"]:
        assert not r["async_identity"]["metrics"] and not r["async_identity"]["state"]


def test_async_bounded_staleness_staggers_shard_clocks(worlds):
    ages = [r["async"]["age"] for r in worlds["w4"]]
    assert len(set(ages)) > 1 and all(a < 4 for a in ages), ages
    # shard d republishes after iteration it where (it + 1 + d) % 4 == 0
    last = [max(it for it in range(96) if (it + 1 + d) % 4 == 0) for d in range(4)]
    assert ages == [95 - it for it in last], ages
    hist = worlds["w4"][0]["async"]["hist"]
    assert int(hist["env_steps"][-1]) == 96 * 8 and int(hist["learn_steps"][-1]) > 0
    assert torch.isfinite(hist["loss"]).all()


def test_pod_data_compressed_e2e_and_payload(worlds):
    r = worlds["w4"][0]["pod_e2e"]
    hist = r["hist"]
    env_steps, learns = int(hist["env_steps"][-1]), int(hist["learn_steps"][-1])
    assert r["n_shards"] == 4 and env_steps == 192 * 8 and learns > 0
    assert abs((env_steps - 128) / learns - 8.0) <= 1.0
    assert int(hist["buffer_size"][-1]) == 192 * 8
    assert torch.isfinite(hist["loss"]).all()
    assert float(hist["compress_error_norm"][-1]) > 0.0
    assert r["q_dtypes"] == {"torch.int8"} and r["payload"] * 3.9 < r["raw"]


def test_compressed_tracks_uncompressed(worlds):
    r = worlds["w4"][0]["compress_vs_plain"]
    assert not r["counters"] and r["finite"] and r["max_param_diff"] < 0.1, r


def test_overlapped_pod_reduce_threads_its_triple(worlds):
    """The overlapped pod leg applies the previous event's cross-pod mean
    plus this pod's own delta: the state is identical within a pod, and
    the pods differ by the delta's disagreement, which does not compound."""
    ranks = [r["overlap"] for r in worlds["w4"]]
    r = ranks[0]
    assert torch.isfinite(r["loss"]).all()
    assert r["keys"] == ["ef", "prev_mean", "prev_partial"] and r["moved"] > 0
    assert not _differing(ranks[0]["state"], ranks[1]["state"])
    assert not _differing(ranks[2]["state"], ranks[3]["state"])
    apart = max(float((ranks[0]["state"][k] - ranks[2]["state"][k]).abs().max())
                for k in ranks[0]["state"] if k.startswith("params/"))
    # Adam moves a parameter about lr (1e-3) a step: the pods stay within it
    assert 0 < apart < 1e-3 * int(ranks[0]["state"]["opt/count"]), apart


def test_elastic_restore_across_world_sizes(worlds):
    """World 2 → 1 and world 1 → 4: the learner state comes back bit for
    bit on every rank, and after the replay refills a step learns."""
    for world in ("w1", "w4"):
        for r in worlds[world]:
            e = r["elastic"]
            assert not e["differing"], (world, e["differing"][:4])
            assert e["step"] == (40 if world == "w1" else 41)
            assert math.isfinite(e["loss"]) and e["iterations"] == 17


# -- the quickstart ------------------------------------------------------------------


def test_quickstart_sharded_on_cpu(capfd):
    from repro_torch import quickstart
    summary, hist = quickstart.main(["--device", "cpu", "--shards", "2", "--n-envs", "8",
                                     "--iterations", "70", "--backend", "torch"])
    # warmup 500: iterations 63..69 learn, 8 learner calls each
    assert summary["env_steps"] == 560 and summary["learn_steps"] == 7 * 8
    assert int(hist["buffer_size"][-1]) == 560
    out = capfd.readouterr().out
    assert "sharded executor: 2 shards × 4 envs, batch/shard 32, reduce f32 pmean" in out


def test_quickstart_sharding_argument_errors(capsys):
    from repro_torch import quickstart
    for argv, msg in ((["--compress-pod-reduce"], "needs --pods"),
                      (["--bf16-intra-pod"], "needs --shards"),
                      (["--shards", "2", "--backend-dist", "nccl", "--device", "cpu"],
                       "a card per rank")):
        with pytest.raises(SystemExit) as e:
            quickstart.main(argv)
        assert e.value.code == 2 and msg in capsys.readouterr().err
