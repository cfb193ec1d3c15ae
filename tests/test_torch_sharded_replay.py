"""The port's sharded replay (repro_torch.core.distributed) — ports of
tests/test_sharded_replay.py (1-D and two-axis) and of
tests/test_distributed.py's stratified-weights math, with the reference's
``ShardedPrioritizedReplay.sample`` under ``jax.vmap`` on the same trees
and the same uniform draws.

The shards run on four gloo ranks spawned once for the module
(launch/mesh.py::spawn), as a 1-D mesh of 4 and as a 2×2 (pod, data) mesh;
the rank function lives in this module, so JAX is imported inside the
tests.  Tolerances: counts, indices and each shard's rows exactly; the
weights against the reference's at rtol 1e-6 (XLA's and torch's powf
differ by up to an ulp: 1,338 of 100,000 draws at β = 0.4 on the CPU);
against the host's recomputation from the global stats at rtol 1e-5, as
the reference's test.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import ShardedPrioritizedReplay, ShardedReplayConfig
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig, ReplayState
from repro_torch.launch import mesh as meshlib

B = 16


def _example():
    return {"obs": torch.zeros((3,), dtype=torch.float32),
            "reward": torch.zeros((), dtype=torch.float32)}


def _replay(axes):
    return ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=64, fanout=8, axis_names=axes),
        _example(), device="cpu")


def _items(n_cells):
    return {"obs": np.arange(n_cells * 32 * 3, dtype=np.float32).reshape(n_cells * 32, 3),
            "reward": np.repeat(np.arange(n_cells, dtype=np.float32), 32)}


def _replay_rank(rank, path):
    """On each rank: the 1-D mesh of 4, then the 2×2 mesh; inserts, sample,
    and a sample of the reference's tree carried across."""
    torch.set_num_threads(1)
    with np.load(path) as f:
        inputs = dict(f)
    out = {}
    for name, mesh, axes in (("1d", meshlib.data_mesh(4), ("data",)),
                             ("2d", meshlib.pod_data_mesh(2, 2), ("pod", "data"))):
        rb = _replay(axes)
        sid = mesh.shard_id
        items = {k: torch.from_numpy(v[sid * 32:(sid + 1) * 32].copy())
                 for k, v in _items(4).items()}
        state = rb.insert(rb.init(), items)
        if name == "2d":
            # cell 3's priorities 9× the others': the global max normalizer
            # comes from another cell than the one that samples it
            state = rb.update_priorities(state, torch.arange(32),
                                         torch.full((32,), 9.0 if sid == 3 else 1.0))
        u = torch.from_numpy(inputs[f"{name}/u"][sid].copy())
        idx, got, w = rb.sample(state, None, B, beta=1.0, mesh=mesh, u=u)
        g_tot, g_cnt = rb.global_stats(state, mesh)
        out[name] = {"count": state.count, "idx": idx.numpy(), "reward": got["reward"].numpy(),
                     "w": w.numpy(), "pri": rb.local.get_priority(state, idx).numpy(),
                     "g_tot": float(g_tot), "g_cnt": float(g_cnt)}
        # the reference's shard, carried across
        ref = ReplayState(tree=torch.from_numpy(inputs[f"{name}/tree"][sid].copy()),
                          storage={k: torch.from_numpy(inputs[f"{name}/{k}"][sid].copy())
                                   for k in ("obs", "reward")},
                          head=int(inputs[f"{name}/count"][sid]),
                          count=int(inputs[f"{name}/count"][sid]),
                          max_priority=torch.tensor(1.0))
        idx, got, w = rb.sample(ref, None, B, beta=0.4, mesh=mesh,
                                u=torch.from_numpy(inputs[f"{name}/ref_u"][sid].copy()))
        out[name]["ref_idx"], out[name]["ref_w"] = idx.numpy(), w.numpy()
        out[name]["ref_reward"] = got["reward"].numpy()
    return out


def _reference_shards(axes, n_cells, key_seed):
    """The reference's replay shards (inserted, skewed on the 2×2 mesh) and
    its vmapped sample → (per-shard arrays, the sample's outputs, u)."""
    import jax
    import jax.numpy as jnp

    from repro.core.distributed import ShardedPrioritizedReplay as JSharded
    from repro.core.distributed import ShardedReplayConfig as JConfig
    jrb = JSharded(JConfig(capacity_per_shard=64, fanout=8, axis_names=axes),
                   {"obs": jnp.zeros((3,), jnp.float32), "reward": jnp.zeros(())})
    items = _items(n_cells)
    rng = np.random.default_rng(key_seed)
    states = []
    for sid in range(n_cells):
        n = 20 + 7 * sid          # a different fill per shard
        st = jrb.insert(jrb.init(), {k: jnp.asarray(v[sid * 32: sid * 32 + n])
                                     for k, v in items.items()})
        st = jrb.update_priorities(st, jnp.arange(n),
                                   jnp.asarray(rng.uniform(0.1, 3.0, n).astype(np.float32)))
        states.append(st)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), n_cells)
    u = np.stack([np.asarray(jax.random.uniform(k, (B,))) for k in keys])

    def one(st, key):
        return jrb.sample(st, key, B, 0.4)

    if len(axes) == 1:
        fn = jax.jit(jax.vmap(one, axis_name=axes[0]))
        out = fn(stacked, keys)
    else:
        fn = jax.jit(jax.vmap(jax.vmap(one, axis_name=axes[1]), axis_name=axes[0]))
        out = fn(jax.tree.map(lambda x: x.reshape((2, 2) + x.shape[1:]), stacked),
                 keys.reshape(2, 2, -1))
        out = jax.tree.map(lambda x: x.reshape((4,) + x.shape[2:]), out)
    arrays = {"tree": np.asarray(stacked.tree), "count": np.asarray(stacked.count),
              "obs": np.asarray(stacked.storage["obs"]),
              "reward": np.asarray(stacked.storage["reward"])}
    return arrays, jax.device_get(out), u


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs, refs = {}, {}
    rng = np.random.default_rng(0)
    for name, axes in (("1d", ("data",)), ("2d", ("pod", "data"))):
        arrays, out, u = _reference_shards(axes, 4, 11 if name == "1d" else 12)
        inputs.update({f"{name}/{k}": v for k, v in arrays.items()})
        inputs[f"{name}/ref_u"] = u
        inputs[f"{name}/u"] = rng.uniform(size=(4, B)).astype(np.float32)
        refs[name] = out
    path = tmp_path_factory.mktemp("sharded_replay") / "inputs.npz"
    np.savez(path, **inputs)
    return refs, meshlib.spawn(_replay_rank, 4, str(path), backend="gloo", device="cpu",
                               timeout_s=300)


def test_config_validation_matches_reference():
    with pytest.raises(ValueError, match="at least one mesh axis"):
        _replay(())
    with pytest.raises(ValueError, match="duplicate mesh axes"):
        _replay(("data", "data"))
    rb = _replay(("pod", "data"))
    assert rb.local.config.capacity == 64 and rb.spec.fanout == 8


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_sharded_sample_global_stats_and_locality(ranks, name):
    """Global count summed over every axis, each shard sampling its own
    rows, weights against the global distribution and the global max."""
    _, res = ranks
    r = [x[name] for x in res]
    assert all(x["count"] == 32 for x in r)
    for x in r:
        assert x["g_cnt"] == 128.0 and x["g_tot"] == r[0]["g_tot"] > 0
    for sid, x in enumerate(r):
        assert (x["reward"] == sid).all(), (sid, x["reward"])
    pri = np.stack([x["pri"] for x in r])
    w = np.stack([x["w"] for x in r])
    assert (w > 0).all() and w.max() <= 1.0 + 1e-6
    w_ref = (r[0]["g_cnt"] * pri / r[0]["g_tot"]) ** -1.0
    w_ref = np.where(pri > 0, w_ref, 0.0)
    np.testing.assert_allclose(w, w_ref / w_ref.max(), rtol=1e-5)
    np.testing.assert_allclose(w.max(), 1.0, rtol=1e-6)
    if name == "2d":
        assert w[3].max() < 0.9      # the skewed cell is normalized by the others' max


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_sharded_sample_matches_reference(ranks, name):
    refs, res = ranks
    idx, items, w = refs[name]
    got_idx = np.stack([x[name]["ref_idx"] for x in res])
    np.testing.assert_array_equal(got_idx, np.asarray(idx))
    np.testing.assert_array_equal(np.stack([x[name]["ref_reward"] for x in res]),
                                  np.asarray(items["reward"]))
    np.testing.assert_allclose(np.stack([x[name]["ref_w"] for x in res]), np.asarray(w),
                               rtol=1e-6)


def test_global_stats_weight_math_matches_reference():
    """One shard's sample with given global stats (and a max across) against
    the reference's ``PrioritizedReplay.sample`` on the same tree and
    draws: indices exact, weights at rtol 1e-6 (powf)."""
    import jax
    import jax.numpy as jnp

    from repro.core.replay import PrioritizedReplay as JReplay
    from repro.core.replay import ReplayConfig as JConfig
    from repro_torch import interop
    jr = JReplay(JConfig(capacity=300, fanout=8),
                 {"obs": jnp.zeros((3,), jnp.float32), "reward": jnp.zeros(())})
    rng = np.random.default_rng(5)
    st = jr.insert(jr.init(), {"obs": jnp.asarray(rng.normal(size=(250, 3)).astype(np.float32)),
                               "reward": jnp.asarray(rng.normal(size=250).astype(np.float32))})
    st = jr.update_priorities(st, jnp.arange(250),
                              jnp.asarray(rng.uniform(0, 2, 250).astype(np.float32)))
    key = jax.random.PRNGKey(3)
    g_tot, g_cnt, g_max = np.float32(3.0 * float(st.tree[0])), np.float32(1000.0), 7.5
    j_idx, _, j_w = jr.sample(st, key, 64, 0.4, global_total=jnp.asarray(g_tot),
                              global_count=jnp.asarray(g_cnt),
                              max_across=lambda x: jnp.maximum(x, g_max))
    tr = PrioritizedReplay(ReplayConfig(capacity=300, fanout=8), _example(), device="cpu")
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (64,))))
    t_idx, _, t_w = tr.sample(interop.replay_state_from_numpy(jax.device_get(st)), None, 64,
                              0.4, u=u, global_total=torch.tensor(g_tot),
                              global_count=torch.tensor(g_cnt),
                              max_across=lambda x: torch.clamp(x, min=g_max))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-6)
    # without global stats the same call is the local sample bit for bit
    local = tr.sample(interop.replay_state_from_numpy(jax.device_get(st)), None, 64, 0.4, u=u)
    one = tr.sample(interop.replay_state_from_numpy(jax.device_get(st)), None, 64, 0.4, u=u,
                    global_total=torch.as_tensor(np.asarray(st.tree[0])),
                    global_count=torch.tensor(float(st.count)), max_across=lambda x: x)
    for a, b in zip((local[0], local[2]), (one[0], one[2])):
        assert torch.equal(a, b)


def test_stratified_weights_are_unbiased():
    """tests/test_distributed.py's numpy simulation of two shards: the
    PER-weighted mean recovers the uniform mean at β = 1."""
    rng = np.random.default_rng(0)
    p1, p2 = rng.uniform(0.1, 1, 128), rng.uniform(0.1, 1, 128)
    values = rng.normal(size=256)
    g_total, g_count = p1.sum() + p2.sum(), 256
    est = []
    for p, vals in ((p1, values[:128]), (p2, values[128:])):
        idx = rng.choice(128, size=20_000, p=p / p.sum())
        w = (g_count * (p[idx] / g_total)) ** -1.0
        est.append((vals[idx] * w).mean() * (p.sum() / g_total) * 2)
    assert abs(0.5 * (est[0] + est[1]) - values.mean()) < 0.05
