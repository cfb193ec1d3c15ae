"""Serving on a mesh of ranks (``backbone.prefill``/``decode_step``,
``token_dqn.serve_step``, ``DecodeEngine``/``ActorServer`` with ``shd``,
``launch/sharded.py::shard_params``) against the JAX package, on the CPU.

  * ``prefill``, three ``decode_step``s and three ``serve_step``s at
    InternLM2 SMOKE size (f32; 4 query heads, 2 KV heads) on gloo meshes
    1×1, 2×1, 1×2 and 1×4, with ``cache_shard`` "heads" and "seq" under
    naive attention and "seq" under flash (the kernels' plain versions;
    flash changes the prefill only, whose K/V "seq" writes in pieces),
    against the reference's ``jax.jit(prefill / decode_step / serve_step,
    in_shardings=...)`` under ``use_mesh(small_mesh(...))``, in a
    subprocess of four forced host devices for each attention path (the
    two side by side).  1×4 is the uneven-heads case: 2 KV heads on a
    4-wide model axis.  Logits and cache at
    ``tests/test_torch_models.py``'s rules (atol 1e-5, rtol 1e-4); the
    actions exact but where the two greedy picks are a near-tie (their
    logits within 1e-5 on the reference's side).  The decode tokens are
    fixed inputs (teacher forcing), so an early tie cannot steer the rest.
  * ``train_step`` on 1×4 (naive and flash) against the reference's
    sharded step, by ``tests/test_torch_sharding.py``'s rules.
  * The 1×1 mesh equals the unsharded port bit for bit (one intra-op
    thread on both sides); every rank gathers the same whole results; each
    rank's cache pieces hold exactly ``tree_device_bytes`` of
    ``cache_specs``.
  * ``ActorServer`` with ``shd`` on 1×2 (the sequence split) and 2×1 (the
    slots split) answers the same requests with the same tokens as the
    unsharded server, and refuses ``start()`` and a ``param_source``.

The port's ranks are spawned once a mesh for the module, the four worlds
side by side, and their functions live here.
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
from repro_torch.configs import get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded
from repro_torch.launch import specs as S
from repro_torch.models import backbone as tb
from repro_torch.models import layers as L
from repro_torch.serve.server import ActorServeConfig, ActorServer

torch.set_num_threads(2)

MESHES = ((1, 1), (2, 1), (1, 2), (1, 4))
IMPLS = ("naive", "flash")
MODES = {"naive": ("heads", "seq"), "flash": ("seq",)}
CASES = [(impl, mode, nd, nm) for impl in IMPLS for mode in MODES[impl] for nd, nm in MESHES]
B, SEQ, MAX_LEN, STEPS = 4, 128, 136, 3
TRAIN_MESH = (1, 4)
SERVER_MESHES = ((1, 2), (2, 1))

REFERENCE = r'''
import dataclasses, functools, os, pickle, sys
# one compute thread: the two reference processes run beside the ranks
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import numpy as np
import jax, jax.numpy as jnp
from repro.agents import token_dqn as jdqn
from repro.configs import get_config
from repro.launch.mesh import sharding_config, small_mesh, use_mesh
from repro.launch.specs import shardings_for, batch_specs, cache_specs
from repro.models import backbone

with np.load(sys.argv[2]) as f:
    inp = dict(f)
shd = sharding_config(False)
out = {"serve": {}, "train": {}}
params = jax.device_get(backbone.init_params(get_config("internlm2_1_8b", smoke=True),
                                             jax.random.PRNGKey(0)))
out["params"] = params
tokens = {"tokens": jnp.asarray(inp["tokens"])}
IMPL = sys.argv[3]
for impl, mode, nd, nm in [c for c in CASES if c[0] == IMPL]:
        cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl=impl,
                                  cache_shard=mode)
        mesh = small_mesh(nd, nm)
        p_sh = shardings_for(params, backbone.param_specs(cfg, shd, params), mesh)
        t_sh = shardings_for(tokens, batch_specs(tokens, shd), mesh)
        with use_mesh(mesh):
            pre = jax.jit(lambda p, t: backbone.prefill(cfg, shd, p, t, MAX_LEN),
                          in_shardings=(p_sh, t_sh["tokens"]))
            logits, cache = pre(params, tokens["tokens"])
            c_sh = shardings_for(cache, cache_specs(cfg, shd, cache), mesh)
            dec = jax.jit(functools.partial(backbone.decode_step, cfg, shd),
                          in_shardings=(p_sh, c_sh, t_sh["tokens"]))
            srv = jax.jit(functools.partial(jdqn.serve_step, cfg, shd),
                          in_shardings=(p_sh, c_sh, t_sh["tokens"]))
            rec = {"logits": np.asarray(logits), "k": np.asarray(cache["k"]),
                   "v": np.asarray(cache["v"]), "step_logits": [], "actions": []}
            c_dec = c_srv = cache
            for i in range(STEPS):
                nxt = jnp.asarray(inp["steps"][:, i:i + 1])
                lg, c_dec = dec(params, jax.device_put(c_dec, c_sh), nxt)
                a, c_srv = srv(params, jax.device_put(c_srv, c_sh), nxt)
                rec["step_logits"].append(np.asarray(lg))
                rec["actions"].append(np.asarray(a))
            rec["k_after"], rec["v_after"] = np.asarray(c_dec["k"]), np.asarray(c_dec["v"])
            rec["srv_k_after"] = np.asarray(c_srv["k"])
        out["serve"][(impl, mode, nd, nm)] = rec

batch = {k: inp["b_" + k] for k in ("tokens", "actions", "rewards", "dones", "is_weights")}
for impl in [IMPL]:
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl=impl)
    tcfg = jdqn.TokenDQNConfig()
    jstate = jdqn.init_train_state(cfg, tcfg, jax.random.PRNGKey(3))
    jstate = jstate._replace(target=jdqn.init_train_state(cfg, tcfg, jax.random.PRNGKey(4)).params)
    out["init"] = jax.device_get(jstate)
    mesh = small_mesh(*TRAIN_MESH)
    state_sh = shardings_for(jax.eval_shape(lambda: jstate), jdqn.state_specs(cfg, shd, jstate),
                             mesh)
    batch_sh = shardings_for(batch, batch_specs(batch, shd), mesh)
    with use_mesh(mesh):
        step = jax.jit(functools.partial(jdqn.train_step, cfg, shd, tcfg),
                       in_shardings=(state_sh, batch_sh))
        out["train"][impl] = jax.device_get(step(jstate, {k: jnp.asarray(v)
                                                          for k, v in batch.items()}))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def smoke_cfg(impl, mode="auto"):
    return dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl=impl,
                               cache_shard=mode)


def _inputs():
    rng = np.random.default_rng(11)
    vocab = smoke_cfg("naive").vocab_size
    dones = np.zeros((B, SEQ), np.float32)
    dones[:, 63] = 1.0
    return {"tokens": rng.integers(0, vocab, (B, SEQ)).astype(np.int32),
            "steps": rng.integers(0, vocab, (B, STEPS)).astype(np.int32),
            "b_tokens": rng.integers(0, vocab, (B, SEQ)).astype(np.int32),
            "b_actions": rng.integers(0, vocab, (B, SEQ)).astype(np.int32),
            "b_rewards": rng.uniform(0, 1, (B, SEQ)).astype(np.float32),
            "b_dones": dones,
            "b_is_weights": rng.uniform(0.5, 1.0, B).astype(np.float32)}


REQUESTS = [(np.arange(n) * 7 % 256 + 3, gen) for n, gen in ((5, 4), (12, 3), (9, 5), (16, 2),
                                                              (3, 4))]


SERVE_CFG = ActorServeConfig(slots=2, max_len=24, buckets=(8, 16))


def serve_requests(cfg, params, shd, device="cpu"):
    """The requests through an ``ActorServer`` of 2 slots → each
    completion's tokens in request order."""
    server = ActorServer(cfg, params, SERVE_CFG, shd, device=device)
    handles = [server.submit(p, g) for p, g in REQUESTS]
    server.drain(timeout=300)
    return [h.result().tokens for h in handles]


def refusals(cfg, params, shd):
    """The errors a sharded ``ActorServer`` raises at ``start()`` and at a
    ``param_source`` (None where it raised none)."""
    server = ActorServer(cfg, params, SERVE_CFG, shd, device="cpu")
    calls = (server.start,
             lambda: ActorServer(cfg, params, SERVE_CFG, shd, param_source=object(),
                                 device="cpu"))
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except (RuntimeError, ValueError) as e:
            out.append(type(e).__name__)
    server.stop()
    return out


# -- the port's side on ranks ------------------------------------------------------


def _full(t):
    return (t.full_tensor() if L.is_dtensor(t) else t).detach().clone()


def _cache_bytes(cfg, shd, cache, dm):
    """(this rank's bytes of the cache's pieces, ``tree_device_bytes`` of
    ``cache_specs`` on the mesh), ``pos`` left out."""
    leaves = {k: v for k, v in S.flat_leaves(cache).items() if k != "pos"}
    specs = S.flat_leaves(S.cache_specs(cfg, shd, cache))
    held = sum(L.local(t).numel() * L.local(t).element_size() for t in leaves.values())
    return held, S.tree_device_bytes(leaves, specs, dm)


def serve_case(cfg, params, shd, inp, dm=None):
    """prefill, ``STEPS`` decode_steps and (from a copy of the prefilled
    cache) as many serve_steps on the fixed step tokens → whole tensors."""
    tokens = torch.from_numpy(inp["tokens"]).long()
    steps = torch.from_numpy(inp["steps"]).long()
    logits, cache = tb.prefill(cfg, params, tokens, MAX_LEN, shd=shd)
    served = {k: v.clone() for k, v in cache.items()}
    rec = {"logits": _full(logits), "k": _full(cache["k"]), "v": _full(cache["v"]),
           "pos": _full(cache["pos"]), "step_logits": [], "actions": []}
    if dm is not None:
        rec["bytes"] = _cache_bytes(cfg, shd, cache, dm)
        rec["placements"] = tuple(type(p).__name__ for p in cache["k"].placements)
    for i in range(STEPS):
        lg, cache = tb.decode_step(cfg, params, cache, steps[:, i:i + 1], shd=shd)
        rec["step_logits"].append(_full(lg))
    rec["k_after"], rec["v_after"] = _full(cache["k"]), _full(cache["v"])
    cache = served
    for i in range(STEPS):
        a, cache = tdqn.serve_step(cfg, params, cache, steps[:, i:i + 1], shd=shd)
        assert not L.is_dtensor(a)
        rec["actions"].append(a.clone())
    rec["srv_k_after"] = _full(cache["k"])
    return rec


def _serve_rank(rank, path, cases, servers, train):
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=False)
    shd = meshlib.sharding_config(False)
    out = {}
    for impl, mode, nd, nm in cases:
        cfg = smoke_cfg(impl, mode)
        dm = meshlib.to_device_mesh(meshlib.small_mesh(nd, nm), "cpu")
        params = sharded.shard_params(cfg, shd, saved["params"](cfg), dm)
        out[(impl, mode, nd, nm)] = serve_case(cfg, params, shd, saved["inputs"], dm)
    for nd, nm in servers:
        cfg = smoke_cfg("naive")
        dm = meshlib.to_device_mesh(meshlib.small_mesh(nd, nm), "cpu")
        params = sharded.shard_params(cfg, shd, saved["params"](cfg), dm)
        out[("server", nd, nm)] = serve_requests(cfg, params, shd)
        out[("refused", nd, nm)] = refusals(cfg, params, shd)
    if train:
        for impl in IMPLS:
            cfg = smoke_cfg(impl)
            tcfg = tdqn.TokenDQNConfig()
            state = saved["train"](cfg)
            dm = meshlib.to_device_mesh(meshlib.small_mesh(*TRAIN_MESH), "cpu")
            state = sharded.shard_train_state(cfg, shd, tcfg, state.params, state.target, dm)
            batch = {k: torch.from_numpy(saved["inputs"]["b_" + k])
                     for k in ("tokens", "actions", "rewards", "dones", "is_weights")}
            state, metrics, tds = tdqn.train_step(cfg, shd, tcfg, state,
                                                  sharded.shard_batch(shd, batch, dm))
            out[("train", impl)] = {"state": sharded.full_state(state),
                                    "metrics": {k: float(v) for k, v in metrics.items()},
                                    "tds": tds.numpy()}
    return out


class _Params:
    """A picklable maker of the port's network from the reference's numpy
    parameters (the ranks build their own copy)."""

    def __init__(self, params):
        self.params = params

    def __call__(self, cfg):
        from repro_torch import interop
        return interop.backbone_params_from_numpy(cfg, self.params)


class _State:
    def __init__(self, state):
        self.state = state

    def __call__(self, cfg):
        from repro_torch import interop
        return interop.train_state_from_numpy(cfg, self.state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's ranks, side by side."""
    import jax

    from repro.agents import token_dqn as jdqn
    from repro.configs import get_config as jget
    from repro.models import backbone as jb

    tmp = tmp_path_factory.mktemp("sharded_serve")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    script = (f"CASES = {CASES!r}\n"
              f"MAX_LEN, STEPS, TRAIN_MESH = {MAX_LEN}, {STEPS}, {TRAIN_MESH!r}\n")
    ref_procs = [subprocess.Popen([sys.executable, "-c", script + REFERENCE,
                                   str(tmp / f"ref_{impl}.pkl"), str(tmp / "inputs.npz"), impl],
                                  env=env) for impl in IMPLS]
    jcfg = jget("internlm2_1_8b", smoke=True)
    params = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    jt = jdqn.TokenDQNConfig()
    jstate = jdqn.init_train_state(jcfg, jt, jax.random.PRNGKey(3))
    jstate = jax.device_get(jstate._replace(
        target=jdqn.init_train_state(jcfg, jt, jax.random.PRNGKey(4)).params))
    torch.save({"params": _Params(params), "train": _State(jstate), "inputs": inp},
               tmp / "init.pt")
    # a world a mesh, side by side: DTensor's first calls on a mesh (its
    # sharding propagation) take seconds, so the meshes warm up at once
    with ThreadPoolExecutor(len(MESHES)) as pool:
        worlds = {m: pool.submit(meshlib.spawn, _serve_rank, m[0] * m[1], str(tmp / "init.pt"),
                                 [c for c in CASES if c[2:] == m],
                                 [m] if m in SERVER_MESHES else [], m == TRAIN_MESH,
                                 backend="gloo", device="cpu")
                  for m in MESHES}
        port = {m: w.result() for m, w in worlds.items()}
    ref = {"serve": {}, "train": {}}
    for impl, proc in zip(IMPLS, ref_procs):
        assert proc.wait(timeout=600) == 0
        with open(tmp / f"ref_{impl}.pkl", "rb") as f:
            part = pickle.load(f)
        ref["params"] = part["params"]
        for key in ("serve", "train"):
            ref[key].update(part[key])
    return {"ref": ref, "port": port, "inputs": inp}


def close(got, want, what, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


def check_actions(got, want, logits, what):
    """Greedy actions equal, but where the two picks are a near-tie of the
    reference's logits (within 1e-5)."""
    got, want, logits = np.asarray(got), np.asarray(want), np.asarray(logits)[:, -1]
    for row in np.nonzero(got != want)[0]:
        gap = abs(logits[row, got[row]] - logits[row, want[row]])
        assert gap <= 1e-5, f"{what}: row {row} picks {got[row]} vs {want[row]} (gap {gap})"


@pytest.mark.parametrize("key", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}x{c[3]}")
def test_sharded_serving_matches_reference(key, runs):
    want = runs["ref"]["serve"][key]
    ranks = runs["port"][key[2:]]
    for r, got in enumerate(rank[key] for rank in ranks):
        what = f"{key} rank {r}"
        close(got["logits"], want["logits"], f"{what} prefill logits")
        for name in ("k", "v", "k_after", "v_after", "srv_k_after"):
            close(got[name], want[name], f"{what} cache {name}")
        assert got["pos"].tolist() == [SEQ] * B
        for i in range(STEPS):
            close(got["step_logits"][i], want["step_logits"][i], f"{what} step {i} logits")
            check_actions(got["actions"][i], want["actions"][i], want["step_logits"][i],
                          f"{what} step {i}")
        held, want_bytes = got["bytes"]
        assert held == want_bytes, (what, held, want_bytes)
    for got in ranks[1:]:       # every rank gathers the same whole results
        for name in ("logits", "k", "k_after"):
            assert torch.equal(got[key][name], ranks[0][key][name]), name
        for a, b in zip(got[key]["actions"], ranks[0][key]["actions"]):
            assert torch.equal(a, b)


def test_uneven_heads_split_the_sequence(runs):
    """On 1×4 the model axis divides neither the 2 KV heads (the cache's
    heads stay whole, so "heads" replicates them and "seq" splits the
    sequence) nor is it a multiple of them; the cache pieces still hold
    exactly their ``tree_device_bytes``, a quarter of the K/V in seq
    mode."""
    for mode, split in (("heads", False), ("seq", True)):
        got = runs["port"][(1, 4)][0][("naive", mode, 1, 4)]
        held, want = got["bytes"]
        full = 2 * got["k"].numel() * got["k"].element_size()
        assert held == want == (full / 4 if split else full)


@pytest.mark.parametrize("impl", IMPLS)
def test_one_by_one_mesh_is_the_unsharded_serving(impl, runs):
    """The 1×1 mesh's prefill, decode and serve steps equal the unsharded
    port's bit for bit (one intra-op thread on both sides)."""
    from repro_torch import interop

    for mode in MODES[impl]:
        cfg = smoke_cfg(impl, mode)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            params = interop.backbone_params_from_numpy(cfg, runs["ref"]["params"])
            want = serve_case(cfg, params, tdqn.NO_SHARDING, runs["inputs"])
        finally:
            torch.set_num_threads(threads)
        got = runs["port"][(1, 1)][0][(impl, mode, 1, 1)]
        for name in ("logits", "k", "v", "k_after", "v_after", "srv_k_after", "pos"):
            assert torch.equal(got[name], want[name]), (mode, name)
        for a, b in zip(got["step_logits"] + got["actions"],
                        want["step_logits"] + want["actions"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("impl", IMPLS)
def test_uneven_heads_train_step_matches_reference(impl, runs):
    """``train_step`` on 1×4 (2 KV heads on a 4-wide model axis) against
    the reference's sharded step."""
    from test_torch_sharding import check_step

    from repro_torch import interop

    jnew, jmetrics, jtds = runs["ref"]["train"][impl]
    want = interop.train_state_from_numpy(smoke_cfg(impl), jnew)
    ranks = runs["port"][TRAIN_MESH]
    for got in (r[("train", impl)] for r in ranks):
        check_step(got, want, jmetrics, jtds)
    for got in ranks[1:]:
        for k, t in got[("train", impl)]["state"].items():
            assert torch.equal(t, ranks[0][("train", impl)]["state"][k]), k


@pytest.mark.parametrize("mesh", SERVER_MESHES)
def test_sharded_actor_server_answers_alike(mesh, runs):
    """``ActorServer`` with ``shd`` on 1×2 and 2×1 answers the requests with
    the unsharded server's tokens, on both ranks."""
    from repro_torch import interop

    cfg = smoke_cfg("naive")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = serve_requests(cfg, interop.backbone_params_from_numpy(cfg, runs["ref"]["params"]),
                              tdqn.NO_SHARDING)
    finally:
        torch.set_num_threads(threads)
    assert [len(t) for t in want] == [g for _, g in REQUESTS]
    for rank in runs["port"][mesh]:
        assert rank[("server", *mesh)] == want


@pytest.mark.parametrize("mesh", SERVER_MESHES)
def test_sharded_actor_server_refuses_a_loop_of_its_own(mesh, runs):
    """A sharded ``ActorServer`` steps in the foreground only: ``start()``
    and a ``param_source`` would admit requests or swap weights at a step
    of each rank's own, so both are refused on every rank."""
    for rank in runs["port"][mesh]:
        assert rank[("refused", *mesh)] == ["RuntimeError", "ValueError"]
