"""Model sharding in the port (``launch/specs.py``, ``launch/mesh.py``'s
production and small meshes, ``backbone.param_specs``/``_cache_kv_spec``,
``token_dqn.state_specs``, ``moe``'s local dispatch, ``launch/sharded.py``)
against the JAX package, on the CPU.

  * The spec trees, entry for entry, for all ten configs at full size
    (from shapes alone: the port's parameters on the meta device, the
    reference's through ``jax.eval_shape``), under ``sharding_config(False)``
    and ``(True)``, with ``moe_ff_tp_fallback`` off and on.  A reference
    spec is compared in the port's layout (``backbone.to_port_spec``: the
    stacked layer axis dropped, transposed leaves reversed).
  * ``tree_device_bytes`` of the state (f32 and bf16 moments) and of a
    (64, 512) cache, exactly, against ``repro.launch.dryrun.
    tree_device_bytes`` on the production meshes of 512 forced host
    devices, computed in a subprocess (this process has imported JAX with
    one device).  The cache's ``pos`` is left out on both sides: the port
    keeps one position a row where the reference keeps a scalar.
  * ``moe`` with ``moe_local_dispatch`` at 16 × 32 tokens against
    ``repro.models.moe.moe`` under ``sharding_config``, at the reference's
    capacity factor and at 0.01 (capacity 8 a shard, tokens drop): expert
    ids exact (but for ``tests/test_torch_moe.py``'s near-tie rule), the
    keep mask against the reference's per-shard rank rule, outputs at its
    atol 1e-5 / rtol 1e-4.
  * ``token_dqn.train_step`` on gloo meshes 1×1, 2×1 and 1×2 (naive, and
    flash through the kernels' plain versions) at InternLM2 SMOKE size (f32)
    against the reference's ``jax.jit(train_step, in_shardings=...)`` under
    ``use_mesh(small_mesh(...))`` in the same subprocess, under
    ``tests/test_torch_token_dqn.py``'s rules (its module docstring: the
    loss, grad norm and |TD| at rtol 1e-5; the moments at rtol 1e-4 plus
    1e-5 of their largest magnitude; parameters at atol 1e-7 where the
    gradient is sure, else within 2·lr; the target at atol 1e-7).  The 1×1
    mesh equals the unsharded port bit for bit (one intra-op thread on
    both sides).  Each rank's pieces hold exactly ``tree_device_bytes``.

The port's ranks are spawned once a world (1 and 2) for the module, and
their function lives here, so JAX is imported inside the tests only.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.agents import token_dqn as tdqn
from repro_torch.agents.base import state_tensors
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded
from repro_torch.launch import specs as S
from repro_torch.models import backbone as tb
from repro_torch.models.config import NO_SHARDING

torch.set_num_threads(2)

MESHES = ((1, 1), (2, 1), (1, 2))
IMPLS = ("naive", "flash")
CACHE_B, CACHE_S = 64, 512

REFERENCE = r'''
import dataclasses, functools, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import numpy as np
import jax, jax.numpy as jnp
from repro.agents import token_dqn as jdqn
from repro.configs import get_config, ARCH_IDS
from repro.launch.mesh import make_production_mesh, sharding_config, small_mesh, use_mesh
from repro.launch.specs import shardings_for, batch_specs, cache_specs
from repro.models import backbone

out = {"bytes": {}, "steps": {}}
with np.load(sys.argv[2]) as f:
    batch = dict(f)
for impl in IMPLS:
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl=impl)
    tcfg = jdqn.TokenDQNConfig()
    jstate = jdqn.init_train_state(cfg, tcfg, jax.random.PRNGKey(3))
    jstate = jstate._replace(target=jdqn.init_train_state(cfg, tcfg, jax.random.PRNGKey(4)).params)
    out["init"] = jax.device_get(jstate)
    shd = sharding_config(False)
    for nd, nm in MESHES:
        mesh = small_mesh(nd, nm)
        state_sh = shardings_for(jax.eval_shape(lambda: jstate),
                                 jdqn.state_specs(cfg, shd, jstate), mesh)
        batch_sh = shardings_for(batch, batch_specs(batch, shd), mesh)
        with use_mesh(mesh):
            step = jax.jit(functools.partial(jdqn.train_step, cfg, shd, tcfg),
                           in_shardings=(state_sh, batch_sh))
            res = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        out["steps"][(impl, nd, nm)] = jax.device_get(res)

# last: importing the dry run sets REPRO_FLASH_STUB, which stands an opaque
# cost stub in for the flash kernel
from repro.launch import dryrun
meshes = {False: make_production_mesh(multi_pod=False), True: make_production_mesh(multi_pod=True)}
to16 = lambda t: jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16), t)
for arch in ARCH_IDS:
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda: jdqn.init_train_state(cfg, jdqn.TokenDQNConfig(),
                                                          jax.random.PRNGKey(0)))
    for multi, mesh in meshes.items():
        shd = sharding_config(multi)
        specs = jdqn.state_specs(cfg, shd, shapes)
        for moments in ("float32", "bfloat16"):
            sh = shapes
            if moments == "bfloat16":
                sh = shapes._replace(opt=shapes.opt._replace(m=to16(shapes.opt.m),
                                                             v=to16(shapes.opt.v)))
            out["bytes"][(arch, multi, moments)] = dryrun.tree_device_bytes(
                sh, shardings_for(sh, specs, mesh))
        cache = jax.eval_shape(lambda: backbone.init_cache(cfg, shd, CACHE_B, CACHE_S))
        cache = {k: v for k, v in cache.items() if k != "pos"}
        out["bytes"][(arch, multi, "cache")] = dryrun.tree_device_bytes(
            cache, shardings_for(cache, cache_specs(cfg, shd, cache), mesh))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def _batch(cfg, b=4, s=128, seed=0):
    rng = np.random.default_rng(seed)
    dones = np.zeros((b, s), np.float32)
    dones[:, 63] = 1.0                      # a terminal mid-segment
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "actions": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "rewards": rng.uniform(0, 1, (b, s)).astype(np.float32),
            "dones": dones,
            "is_weights": rng.uniform(0.5, 1.0, b).astype(np.float32)}


def smoke_cfg(impl):
    """InternLM2 SMOKE with ``impl`` attention, or Mixtral SMOKE for "moe"
    (whose expert dispatch runs replicated on a mesh)."""
    if impl == "moe":
        return get_config("mixtral_8x7b", smoke=True)
    return dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl=impl)


MOE_SEED = 5


def moe_state():
    cfg = smoke_cfg("moe")
    return cfg, tdqn.init_train_state(cfg, tdqn.TokenDQNConfig(),
                                      torch.Generator().manual_seed(MOE_SEED))


# -- the port's side on ranks ------------------------------------------------------


def _step_rank(rank, path, cases):
    """On each rank: for each (impl, n_data, n_model) of ``cases``, the
    networks of the state saved at ``path`` (the reference's initial state,
    carried over; its moments zero) cut into this rank's pieces on that
    mesh by ``sharded.shard_train_state``, one ``train_step`` on them and
    on ``sharded.shard_batch``'s batch → the whole new state, the metrics,
    |TD|, and this rank's bytes."""
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=False)
    batch = {k: torch.from_numpy(v) for k, v in saved["batch"].items()}
    shd = meshlib.sharding_config(False)
    out = {}
    for impl, nd, nm in cases:
        cfg = smoke_cfg(impl)
        tcfg = tdqn.TokenDQNConfig()
        if impl == "moe":
            _, state = moe_state()
        else:
            state = tdqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0))
            with torch.no_grad():
                for k, t in state_tensors(state).items():
                    t.copy_(saved["state"][k])
        dm = meshlib.to_device_mesh(meshlib.small_mesh(nd, nm), "cpu")
        assert int(state.step) == 0 and not any(bool(t.any()) for t in state.opt.m + state.opt.v)
        state = sharded.shard_train_state(cfg, shd, tcfg, state.params, state.target, dm)
        state, metrics, tds = tdqn.train_step(cfg, shd, tcfg, state,
                                              sharded.shard_batch(shd, batch, dm))
        placements = {n: tuple((type(p).__name__, getattr(p, "dim", None)) for p in t.placements)
                      for n, t in state_tensors(state).items() if hasattr(t, "placements")}
        out[(impl, nd, nm)] = {
            "state": sharded.full_state(state), "metrics": {k: float(v) for k, v in
                                                            metrics.items()},
            "tds": tds.numpy(), "local_bytes": sharded.local_state_bytes(state),
            "want_bytes": sharded.state_device_bytes(cfg, shd, state, dm),
            "placements": placements}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess (bytes and sharded steps) and the port's
    ranks, side by side."""
    import jax

    from repro_torch import interop

    tmp = tmp_path_factory.mktemp("sharding")
    batch = _batch(smoke_cfg("naive"))
    np.savez(tmp / "batch.npz", **batch)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    script = f"MESHES = {MESHES!r}\nIMPLS = {IMPLS!r}\nCACHE_B, CACHE_S = {CACHE_B}, {CACHE_S}\n"
    ref_proc = subprocess.Popen([sys.executable, "-c", script + REFERENCE,
                                 str(tmp / "ref.pkl"), str(tmp / "batch.npz")], env=env)
    # the initial state, the reference's own (PRNGKey 3, target from 4)
    from repro.agents import token_dqn as jdqn
    from repro.configs import get_config as jget

    jcfg = jget("internlm2_1_8b", smoke=True)
    jt = jdqn.TokenDQNConfig()
    jstate = jdqn.init_train_state(jcfg, jt, jax.random.PRNGKey(3))
    jstate = jstate._replace(target=jdqn.init_train_state(jcfg, jt, jax.random.PRNGKey(4)).params)
    init = interop.train_state_from_numpy(smoke_cfg("naive"), jax.device_get(jstate))
    torch.save({"state": {k: t.detach() for k, t in state_tensors(init).items()},
                "batch": batch}, tmp / "init.pt")
    one = [(impl, 1, 1) for impl in IMPLS]
    two = [(impl, nd, nm) for impl in IMPLS + ("moe",) for nd, nm in MESHES if nd * nm == 2]
    with ThreadPoolExecutor(2) as pool:      # the two worlds side by side
        worlds = [pool.submit(meshlib.spawn, _step_rank, n, str(tmp / "init.pt"), cases,
                              backend="gloo", device="cpu") for n, cases in ((1, one), (2, two))]
        world1, world2 = (w.result() for w in worlds)
    assert ref_proc.wait(timeout=600) == 0
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"ref": ref, "port": {1: world1, 2: world2}, "batch": batch}


# -- the spec trees ----------------------------------------------------------------


def _ref_at(tree, name):
    """The reference's leaf for the port's parameter ``name``
    (``interop.backbone_leaf``'s walk, without the un-stacking)."""
    parts = name.split(".")
    if parts[0] in tb.STACKED:
        x, path = tree[parts[0]], parts[2:]
    elif parts[0] == "blocks":
        x, path = tree["blocks"][int(parts[1])], parts[2:]
    else:
        x, path = tree, parts
    for key in path:
        x = x[key]
    return x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_match_reference(arch):
    import jax

    from repro.agents import token_dqn as jdqn
    from repro.configs import get_config as jget
    from repro.launch.mesh import sharding_config as jshd
    from repro.models import backbone as jb

    for fallback in (False, True):
        jcfg = dataclasses.replace(jget(arch), moe_ff_tp_fallback=fallback)
        cfg = dataclasses.replace(get_config(arch), moe_ff_tp_fallback=fallback)
        jshapes = jax.eval_shape(lambda: jb.init_params(jcfg, jax.random.PRNGKey(0)))
        params = tb.shape_params(cfg)
        for multi in (False, True):
            shd = meshlib.sharding_config(multi)
            assert shd == type(shd)(**dataclasses.asdict(jshd(multi)))
            want = jb.param_specs(jcfg, jshd(multi), jshapes)
            got = tb.param_specs(cfg, shd, params)
            assert list(got) == [n for n, _ in params.named_parameters()]
            for name, p in params.named_parameters():
                keys, ref_shape, stacked, transposed = tb.reference_leaf(
                    name, tuple(p.shape), tb._stack_depth(params, name))
                leaf = _ref_at(jshapes, name)
                assert tuple(leaf.shape) == ref_shape, (name, leaf.shape, ref_shape)
                spec = tuple(_ref_at(want, name))
                assert got[name] == S.canonical(tb.to_port_spec(
                    spec, len(ref_shape), stacked, transposed)), \
                    (arch, fallback, multi, name, spec, got[name])
            # ZeRO-1: the moments mirror the parameters on both sides
            jspec = jdqn.state_specs(jcfg, jshd(multi), jdqn.TrainState(
                jshapes, jshapes, jdqn.adam.AdamState(None, jshapes, jshapes), None))
            assert jax.tree.leaves(jspec.opt.m, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)) == jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            state = tdqn.TrainState(params, params, tdqn.adam.AdamState(None, [], []), None)
            specs = tdqn.state_specs(cfg, shd, state)
            assert specs.params == specs.target == got
            assert specs.opt.m == specs.opt.v == list(got.values())
            assert specs.opt.count == specs.step == ()
        assert set(tb.param_specs(cfg, NO_SHARDING, params).values()) == {()}


def _flat_specs(tree):
    import jax
    return [tuple(x) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    import jax

    from repro.configs import get_config as jget
    from repro.launch.mesh import sharding_config as jshd
    from repro.launch.specs import cache_specs as jcache_specs
    from repro.models import backbone as jb

    cfg, jcfg = get_config(arch), jget(arch)
    for multi in (False, True):
        shd = meshlib.sharding_config(multi)
        assert tb._cache_kv_spec(cfg, shd) == tuple(jb._cache_kv_spec(jcfg, jshd(multi)))
        jcache = jax.eval_shape(lambda: jb.init_cache(jcfg, jshd(multi), 2, 16))
        cache = tb.init_cache(cfg, 2, 16, device="meta")
        want = jcache_specs(jcfg, jshd(multi), jcache)
        got = S.cache_specs(cfg, shd, cache)
        assert sorted(got) == sorted(want)
        for key in got:
            assert [tuple(s) for s in S.flat_leaves(got[key]).values()] == \
                _flat_specs(want[key]), (arch, multi, key)
    assert tb._cache_kv_spec(cfg, NO_SHARDING) == ()


# -- bytes per device -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_device_bytes_match_reference(arch, runs):
    ref = runs["ref"]["bytes"]
    cfg = get_config(arch)
    for multi in (False, True):
        shd = meshlib.sharding_config(multi)
        mesh = meshlib.make_production_mesh(multi_pod=multi)
        assert not mesh.groups and mesh.axis_sizes == ((2, 16, 16) if multi else (16, 16))
        for moments in ("float32", "bfloat16"):
            leaves, specs = sharded.state_shapes(cfg, shd, moments)
            assert S.tree_device_bytes(leaves, specs, mesh) == ref[(arch, multi, moments)], \
                (arch, multi, moments)
        cache = tb.init_cache(cfg, CACHE_B, CACHE_S, device="meta")
        del cache["pos"]
        leaves = S.flat_leaves(cache)
        specs = S.flat_leaves(S.cache_specs(cfg, shd, cache))
        assert S.tree_device_bytes(leaves, specs, mesh) == ref[(arch, multi, "cache")]


def test_valid_spec_and_placements():
    """``valid_spec`` drops a name that does not divide; ``placements_for``
    puts each named mesh axis on its dimension, in the mesh's axis order."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshlib.make_production_mesh(multi_pod=True)
    assert S.axis_size(mesh, ("pod", "data")) == 32 and S.axis_size(mesh, None) == 1
    assert S.valid_spec((8, 4096), ("model", ("pod", "data")), mesh) == (None, ("pod", "data"))
    assert S.valid_spec((64,), ("model", "data"), mesh) == ("model",)
    assert S.placements_for((64, 4096), (("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert S.placements_for((8, 4096), ("model", None), mesh) == (
        Replicate(), Replicate(), Replicate())
    assert S.num_shards((64, 4096), (("pod", "data"), "model"), mesh) == 512
    small = meshlib.small_mesh(2, 1)
    assert small.axis_names == ("data", "model") and small.axis_sizes == (2, 1)
    assert meshlib.small_mesh().axis_sizes == (1, 1)
    assert S.batch_specs({"tokens": torch.zeros(4, 8), "w": torch.zeros(4)},
                         meshlib.sharding_config(True)) == {
        "tokens": (("pod", "data"), None), "w": (("pod", "data"),)}


# -- moe's local dispatch -----------------------------------------------------------


def local_keep(ids, e, c, shards):
    """The reference's per-shard rank rule on expert ids (T, k)."""
    t = ids.shape[0]
    keep = np.zeros(ids.shape, bool)
    for i in range(shards):
        rows = slice(i * (t // shards), (i + 1) * (t // shards))
        for j in range(ids.shape[1]):
            seen = np.zeros(e, int)
            for r, x in zip(range(rows.start, rows.stop), ids[rows, j]):
                keep[r, j] = seen[x] < c
                seen[x] += 1
    return keep


@pytest.mark.parametrize("cf", [1.25, 0.01])
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "llama4_maverick_400b_a17b"])
def test_moe_local_dispatch_matches_reference(arch, cf):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.launch.mesh import sharding_config as jshd
    from repro.models import backbone as jb
    from repro.models import moe as jm
    from repro_torch import interop
    from repro_torch.models import moe as tm

    over = {"capacity_factor": cf, "moe_local_dispatch": True}
    jcfg = dataclasses.replace(jget(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    model = interop.backbone_params_from_numpy(cfg, params)
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]), params["units"]["moe"]["w"])
    pt = model.units[0]["moe"].w
    b, s = 16, 32                                 # 16 shards × 32 tokens
    x = np.random.default_rng(1).normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    y_ref, m_ref = jm.moe(jcfg, jshd(False), pj, jnp.asarray(x))
    with torch.no_grad(), tm.recording() as rec:
        y, m = tm.moe(cfg, pt, torch.from_numpy(x), shd=meshlib.sharding_config(False))
    r = rec[0]
    assert r["shards"] == 16 and r["capacity"] == jm.capacity(jcfg, b * s // 16)
    probs = np.asarray(jax.nn.softmax(jnp.einsum("td,de->te", x.reshape(b * s, -1),
                                                 pj["router"]), axis=-1))
    ids = np.asarray(jax.lax.top_k(jnp.asarray(probs), jcfg.experts_per_token)[1])
    got = r["expert_id"].numpy()
    flips = np.nonzero((ids != got).any(1))[0]
    for t in flips:                          # tests/test_torch_moe.py's near-tie rule
        for a_, b_ in zip(ids[t], got[t]):
            pa, pb = probs[t, a_], probs[t, b_]
            assert abs(pa - pb) <= 4 * np.spacing(np.float32(max(pa, pb)))
    if cf < 1:
        assert len(flips) == 0 and float(m["dropped_frac"]) > 0
    keep = local_keep(ids, jcfg.num_experts, r["capacity"], 16)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    ok = np.setdiff1d(np.arange(b * s), flips)
    np.testing.assert_allclose(y.numpy().reshape(b * s, -1)[ok],
                               np.asarray(y_ref).reshape(b * s, -1)[ok], atol=1e-5, rtol=1e-4)
    for key in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(float(m[key]), float(m_ref[key]), atol=1e-5, rtol=1e-4)
    # one shard (no local dispatch, or NO_SHARDING) is the unsharded call
    with torch.no_grad():
        y1, _ = tm.moe(dataclasses.replace(cfg, moe_local_dispatch=False), pt,
                       torch.from_numpy(x), shd=meshlib.sharding_config(False))
        y0, _ = tm.moe(cfg, pt, torch.from_numpy(x))
    assert torch.equal(y1, y0)


# -- the sharded train step ---------------------------------------------------------


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def check_step(got, want, wmetrics, wtds):
    """``tests/test_torch_token_dqn.py::check_step``'s rules on a sharded
    step's whole state (``got``: {state_tensors name: tensor}) against
    ``want``, a port ``TrainState``, and its metrics and |TD|."""
    for key in ("loss", "grad_norm", "q_mean"):
        _close(got["metrics"][key], float(wmetrics[key]), 1e-5, 1e-6, key)
    _close(got["tds"], np.asarray(wtds), 1e-5, 1e-6, "per-sequence |TD|")
    state = got["state"]
    assert int(state["step"]) == int(want.step) == 1 and int(state["opt/count"]) == 1
    lr = tdqn.TokenDQNConfig().opt.lr
    names = [n for n, _ in want.params.named_parameters()]
    for i, (name, b, m) in enumerate(zip(names, want.params.parameters(), want.opt.m)):
        a = state[f"params/{name}"]
        sure = m.abs() > 0.1 * 1e-6
        err = (a - b.detach()).abs()
        assert float(err[sure].max()) <= 1e-7, f"params {name}: {float(err[sure].max())}"
        assert float(err.max()) <= 2 * lr + 1e-7, f"params {name}: {float(err.max())}"
        _close(state[f"target/{name}"], list(want.target.parameters())[i], 0, 1e-7,
               f"target {name}")
        for key, ref in (("m", want.opt.m[i]), ("v", want.opt.v[i])):
            ref = np.asarray(ref, np.float64)
            _close(state[f"opt/{key}/{name}"], ref, 1e-4, 1e-5 * float(np.abs(ref).max()),
                   f"{key} {name}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_step_matches_reference(mesh, impl, runs):
    nd, nm = mesh
    from repro_torch import interop

    jnew, jmetrics, jtds = runs["ref"]["steps"][(impl, nd, nm)]
    want = interop.train_state_from_numpy(smoke_cfg(impl), jnew)
    ranks = runs["port"][nd * nm]
    for got in (r[(impl, nd, nm)] for r in ranks):
        check_step(got, want, jmetrics, jtds)
    # every rank gathers the same whole state
    for got in ranks[1:]:
        for k, t in got[(impl, nd, nm)]["state"].items():
            assert torch.equal(t, ranks[0][(impl, nd, nm)]["state"][k]), k


@pytest.mark.parametrize("mesh", MESHES[1:])
def test_moe_train_step_on_a_mesh(mesh, runs):
    """Mixtral SMOKE's train step on 2×1 and 1×2 (its expert dispatch
    replicated on every rank, ``models/moe.py``) against the unsharded port
    step, under the same rules."""
    nd, nm = mesh
    cfg, state = moe_state()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, metrics, tds = tdqn.train_step(cfg, NO_SHARDING, tdqn.TokenDQNConfig(), state,
                                              {k: torch.from_numpy(v)
                                               for k, v in runs["batch"].items()})
    finally:
        torch.set_num_threads(threads)
    for r in runs["port"][2]:
        check_step(r[("moe", nd, nm)], state, metrics, tds.numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_one_by_one_mesh_is_the_unsharded_step(impl, runs):
    """The 1×1 mesh's sharded step equals the unsharded port's step bit for
    bit (both on one intra-op thread)."""
    from repro_torch import interop

    got = runs["port"][1][0][(impl, 1, 1)]
    cfg = smoke_cfg(impl)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = interop.train_state_from_numpy(cfg, runs["ref"]["init"])
        state, metrics, tds = tdqn.train_step(cfg, NO_SHARDING, tdqn.TokenDQNConfig(), state,
                                              {k: torch.from_numpy(v)
                                               for k, v in runs["batch"].items()})
    finally:
        torch.set_num_threads(threads)
    for k, t in state_tensors(state).items():
        assert torch.equal(got["state"][k], t.detach()), k
    assert got["metrics"] == {k: float(v) for k, v in metrics.items()}
    assert np.array_equal(got["tds"], tds.numpy())


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_tree_device_bytes(mesh, runs):
    """Each rank's pieces (the placements ``state_specs`` gives through
    ``placements_for``) hold exactly ``tree_device_bytes`` of the mesh; on
    1×2 the model axis splits the heads' projections, on 2×1 the data
    axis splits the fsdp dimension."""
    nd, nm = mesh
    for r in runs["port"][nd * nm]:
        got = r[("naive", nd, nm)]
        assert got["local_bytes"] == got["want_bytes"]
        # wq (h·hd, d): heads over the model axis, d over the data axis
        assert got["placements"]["params/units.0.attn.w.wq"] == (("Shard", 1), ("Shard", 0))
        full = sum(t.numel() * t.element_size() for t in got["state"].values())
        assert (got["want_bytes"] < full) == (nd * nm == 2)
