"""The port's Mixture-of-Experts layer (repro_torch.models.moe) and the moe
backbone against the JAX package's (repro.models.moe, repro.models.backbone),
on the CPU.

Configs: ``mixtral_8x7b`` SMOKE (E 4, top-2) and ``llama4_maverick_400b_a17b``
SMOKE (E 4, top-1, a shared expert, units of attn → mlp → attn → moe), f32,
at the reference's capacity factor and at ``capacity_factor=0.01``, where the
capacity is 8 and tokens are dropped.  Parameters come from the reference's
``init_params`` through ``interop``; inputs from a seeded numpy generator.

Tolerances: the layer's output, ``aux_loss`` and ``dropped_frac`` at atol
1e-5, rtol 1e-4 (f32 sums in another order).  Expert ids compare exactly,
except where the two routers' probabilities of the two experts in question
lie within TIE_ULPS f32 ulps of each other: there summing in another order
may flip the choice (the sampler's tie rule, tests/test_kernels.py), and that
token is left out of the output comparison.  The kept/dropped mask compares
token for token against the reference's rank rule applied to its expert ids.
Gradients of the token-DQN TD loss at rtol 1e-4 plus an atol of 1e-5 of the
gradient's largest magnitude (tests/test_torch_token_dqn.py's rule); at top-1
the router's gradient is 0 but for rounding on both sides (the renormalized
gate weight is p / p), and is held under 1e-6 of the model's largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents import token_dqn as jdqn
from repro.configs import get_config as jget_config
from repro.models import backbone as jb
from repro.models import layers as jl
from repro.models import moe as jm
from repro.models.config import NO_SHARDING
from repro_torch import interop
from repro_torch.agents import token_dqn as tdqn
from repro_torch.configs import get_config
from repro_torch.models import backbone as tb
from repro_torch.models import layers as tl
from repro_torch.models import moe as tm

torch.set_num_threads(2)

MOE_ARCHS = ("mixtral_8x7b", "llama4_maverick_400b_a17b")
TIE_ULPS = 4


def configs(arch, **over):
    return (dataclasses.replace(jget_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def carried(jcfg, tcfg, seed=0):
    params = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(seed)))
    return params, interop.backbone_params_from_numpy(tcfg, params)


def first_unit(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree)


def ref_route(jcfg, p, x):
    """The reference's router lines (repro.models.moe.moe): probabilities and
    top-k expert ids of the tokens x (T, d)."""
    probs = jax.nn.softmax(jnp.einsum("td,de->te", jnp.asarray(x), p["router"]), axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.experts_per_token)
    return np.asarray(probs), np.asarray(ids)


def rank_keep(ids, e, c):
    """The reference's drop rule on expert ids (T, k): a token is kept in
    slot j while fewer than c earlier tokens chose its expert in slot j."""
    keep = np.zeros(ids.shape, bool)
    for j in range(ids.shape[1]):
        seen = np.zeros(e, int)
        for t, x in enumerate(ids[:, j]):
            keep[t, j] = seen[x] < c
            seen[x] += 1
    return keep


def tie_flips(probs, want, got):
    """Tokens whose expert ids differ; assert each is a near-tie."""
    flips = np.nonzero((want != got).any(1))[0]
    for t in flips:
        for a, b in zip(want[t], got[t]):
            pa, pb = probs[t, a], probs[t, b]
            assert abs(pa - pb) <= TIE_ULPS * np.spacing(np.float32(max(pa, pb))), \
                f"token {t}: experts {want[t]} vs {got[t]}, probabilities {pa} vs {pb}"
    return flips


# -- the layer -------------------------------------------------------------------


def test_capacity_matches_reference():
    for arch in MOE_ARCHS:
        for cf in (1.25, 0.5, 0.01):
            jcfg, tcfg = configs(arch, capacity_factor=cf)
            for tokens in (1, 7, 16, 100, 512, 4096, 4608):
                assert tm.capacity(tcfg, tokens) == jm.capacity(jcfg, tokens), (arch, cf, tokens)
    # the full-width shapes the serve path meets (models/moe.py's docstring)
    assert tm.capacity(get_config("mixtral_8x7b"), 512) == 256
    assert tm.capacity(get_config("mixtral_8x7b"), 4608) == 1536
    assert tm.capacity(get_config("llama4_maverick_400b_a17b"), 16) == 8
    assert tm.capacity(get_config("llama4_maverick_400b_a17b"), 512) == 128


@pytest.mark.parametrize("cf", [1.25, 0.01])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_reference(arch, cf):
    jcfg, tcfg = configs(arch, capacity_factor=cf)
    params, model = carried(jcfg, tcfg)
    pj, pt = first_unit(params["units"]["moe"]["w"]), model.units[0]["moe"].w
    b, s = 3, 40
    x = np.random.default_rng(1).normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    y_ref, m_ref = jm.moe(jcfg, NO_SHARDING, pj, jnp.asarray(x))
    with torch.no_grad(), tm.recording() as rec:
        y, m = tm.moe(tcfg, pt, torch.from_numpy(x))
    assert len(rec) == 1 and rec[0]["tokens"] == b * s
    c = jm.capacity(jcfg, b * s)
    assert rec[0]["capacity"] == c
    probs, ids = ref_route(jcfg, pj, x.reshape(b * s, -1))
    got_ids = rec[0]["expert_id"].numpy()
    flips = tie_flips(probs, ids, got_ids)
    if cf < 1:
        assert len(flips) == 0, "a flipped expert reorders the ranks behind it"
        assert float(m["dropped_frac"]) > 0.5           # the drops are exercised
    keep = rank_keep(ids, jcfg.num_experts, c)
    np.testing.assert_array_equal(rec[0]["keep"].numpy(), keep)
    ok = np.setdiff1d(np.arange(b * s), flips)
    np.testing.assert_allclose(y.numpy().reshape(b * s, -1)[ok],
                               np.asarray(y_ref).reshape(b * s, -1)[ok], atol=1e-5, rtol=1e-4)
    for key in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(float(m[key]), float(m_ref[key]), atol=1e-5, rtol=1e-4)
    assert round(float(m["dropped_frac"]) * keep.size) == int((~keep).sum())


def test_route_and_dropped_if_capped():
    """``route`` gives the reference's renormalized gate weights, and
    ``dropped_if_capped`` counts what the capacity of one call over the same
    tokens would drop: every token on one expert past the capacity."""
    jcfg, tcfg = configs("llama4_maverick_400b_a17b", capacity_factor=0.01)
    params, model = carried(jcfg, tcfg)
    pj, pt = first_unit(params["units"]["moe"]["w"]), model.units[0]["moe"].w
    x = np.random.default_rng(2).normal(size=(30, jcfg.d_model)).astype(np.float32)
    probs, gate_w, ids = tm.route(tcfg, pt, torch.from_numpy(x))
    ref_probs, ref_ids = ref_route(jcfg, pj, x)
    np.testing.assert_allclose(probs.detach().numpy(), ref_probs, atol=1e-6, rtol=1e-5)
    assert len(tie_flips(ref_probs, ref_ids, ids.numpy())) == 0
    np.testing.assert_allclose(gate_w.detach().sum(-1).numpy(), 1.0, rtol=1e-6)
    same = torch.zeros((20, 1), dtype=torch.int64)          # 20 tokens on expert 0
    assert tm.dropped_if_capped(tcfg, same) == 20 - tm.capacity(tcfg, 20) == 12
    spread = torch.arange(20)[:, None] % tcfg.num_experts    # 5 each: under 8
    assert tm.dropped_if_capped(tcfg, spread) == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_distributions(arch):
    cfg = get_config(arch, smoke=True)
    model = tb.init_params(cfg, torch.Generator().manual_seed(0))
    again = tb.init_params(cfg, torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    w = model.units[0]["moe"].w
    d, f = cfg.d_model, cfg.d_ff
    assert w.router.shape == (d, cfg.num_experts) and w.router.dtype == torch.float32
    assert w.w_gate.shape == w.w_up.shape == (cfg.num_experts, d, f)
    assert w.w_down.shape == (cfg.num_experts, f, d)
    for x, fan_in in ((w.router, d), (w.w_gate, d), (w.w_up, d), (w.w_down, f)):
        assert abs(float(x.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1
    # each expert drawn on its own: no two experts alike
    assert float((w.w_gate[0] - w.w_gate[1]).detach().abs().max()) > 0.1
    assert (w.shared is not None) == bool(cfg.num_shared_experts)
    n_ref = sum(x.size for x in jax.tree.leaves(
        jb.init_params(jget_config(arch, smoke=True), jax.random.PRNGKey(0))))
    assert sum(p.numel() for p in model.parameters()) == n_ref


# -- Llama-4's shared attention weights -----------------------------------------------


def test_llama4_attention_sublayers_share_weights(monkeypatch):
    """A Llama-4 unit (attn, mlp, attn, moe) holds ONE set of attention
    weights, in the reference (the second ``p["attn"]`` of ``_unit_init``
    replaces the first) and in the port, and both of its attention
    sub-layers read it, while the KV cache keeps an entry for each."""
    jcfg, tcfg = configs("llama4_maverick_400b_a17b", scan_layers=False, remat=False)
    params, model = carried(jcfg, tcfg)
    n_units = jcfg.num_layers // 2
    assert sorted(params["units"]) == ["attn", "mlp", "moe"]
    assert params["units"]["attn"]["w"]["wq"].shape[0] == n_units
    assert [sorted(u.keys()) for u in model.units] == [["attn", "mlp", "moe"]] * n_units
    tokens = np.random.default_rng(3).integers(0, 256, (1, 6)).astype(np.int32)

    seen_ref = []
    real_mha = jl.mha
    monkeypatch.setattr(jl, "mha", lambda cfg, shd, p, *a, **k: (
        seen_ref.append(np.asarray(p["wq"])), real_mha(cfg, shd, p, *a, **k))[1])
    jb.forward(jcfg, NO_SHARDING, params, jnp.asarray(tokens))
    assert len(seen_ref) == 2 * n_units
    for u in range(n_units):
        np.testing.assert_array_equal(seen_ref[2 * u], seen_ref[2 * u + 1])
        np.testing.assert_array_equal(seen_ref[2 * u], params["units"]["attn"]["w"]["wq"][u])

    seen = []
    real_mha_kv = tl.mha_kv
    monkeypatch.setattr(tl, "mha_kv", lambda cfg, p, *a, **k: (
        seen.append(p), real_mha_kv(cfg, p, *a, **k))[1])
    with torch.no_grad():
        tb.forward(tcfg, model, torch.from_numpy(tokens).long())
    assert [id(p) for p in seen] == [id(u["attn"].w) for u in model.units for _ in (0, 1)]
    cache = tb.init_cache(tcfg, 1, 8)
    ref_cache = jb.init_cache(jcfg, NO_SHARDING, 1, 8)
    assert cache["k"].shape[0] == ref_cache["k"].shape[0] == 2 * n_units


# -- gradients of a moe train step ----------------------------------------------------


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    dones = np.zeros((b, s), np.float32)
    dones[:, 7] = 1.0
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "actions": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "rewards": rng.uniform(0, 1, (b, s)).astype(np.float32),
            "dones": dones,
            "is_weights": rng.uniform(0.5, 1.0, b).astype(np.float32)}


@pytest.mark.parametrize("arch,cf", [("mixtral_8x7b", 1.25),
                                     ("llama4_maverick_400b_a17b", 1.25),
                                     ("llama4_maverick_400b_a17b", 0.01)])
def test_moe_td_loss_gradients_match_reference(arch, cf):
    """The token-DQN TD loss of a moe backbone and its gradients (router,
    experts, shared expert, the shared attention) against ``jax.grad`` of the
    reference's ``_td_loss``; at cf 0.01 with tokens dropped."""
    jcfg, tcfg = configs(arch, capacity_factor=cf)
    params, model = carried(jcfg, tcfg, seed=4)
    target_p, target = carried(jcfg, tcfg, seed=5)
    target.requires_grad_(False)
    batch = _batch(jcfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jt = jdqn.TokenDQNConfig()

    def loss_fn(p):
        return jdqn._td_loss(jcfg, jt, p, target_p, NO_SHARDING, jbatch)[0]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref_grads = jax.device_get(ref_grads)
    loss, _ = tdqn._td_loss(tcfg, tdqn.TokenDQNConfig(), model, target,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5, atol=1e-6)
    largest = max(float(g.abs().max()) for g in grads)
    for (name, _), g in zip(model.named_parameters(), grads):
        want = interop.backbone_leaf(ref_grads, name).astype(np.float64)
        got = g.numpy().astype(np.float64)
        if name.endswith("router") and jcfg.experts_per_token == 1:
            # top-1: the renormalized gate weight is p / p = 1, so the router's
            # gradient is 0 but for rounding, on both sides
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-6 * largest, name
            continue
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    big = {n for (n, _), g in zip(model.named_parameters(), grads)
           if float(g.abs().max()) > 1e-3 * largest}
    assert any("moe.w.w_down" in n for n in big)
    assert any("moe.w.router" in n for n in big) == (jcfg.experts_per_token > 1)


# -- the measurement aids -------------------------------------------------------------


def test_routed_as_pins_the_routes_of_a_recording():
    """A forward inside ``routed_as`` of its own recording is the forward; of
    another input's recording it routes as that input did, its gate weights
    from its own router; more calls than records, or a record of another
    length, raise."""
    _, tcfg = configs("mixtral_8x7b")
    model = tb.init_params(tcfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    a, b = [torch.from_numpy(rng.integers(0, 256, (1, 24))).long() for _ in range(2)]
    with torch.no_grad():
        with tm.recording() as rec_a:
            want = tb.forward(tcfg, model, a)
        with tm.recording() as rec_b:
            tb.forward(tcfg, model, b)
        with tm.routed_as(rec_a), tm.recording() as again:
            got = tb.forward(tcfg, model, a)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        with tm.routed_as(rec_b), tm.recording() as pinned:
            tb.forward(tcfg, model, a)
    assert len(rec_a) == len(pinned) == tcfg.num_layers
    for r, x in zip(pinned, rec_b):
        assert torch.equal(r["expert_id"], x["expert_id"])
    assert any(not torch.equal(x["expert_id"], y["expert_id"]) for x, y in zip(rec_b, rec_a))
    with pytest.raises(ValueError, match="more moe calls"), torch.no_grad():
        with tm.routed_as(rec_a[:1]):
            tb.forward(tcfg, model, a)
    with pytest.raises(ValueError, match="recorded route"), torch.no_grad():
        with tm.routed_as(rec_a):
            tb.forward(tcfg, model, a[:, :8])
