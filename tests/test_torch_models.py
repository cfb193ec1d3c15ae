"""The port's token-model layers and dense backbone (repro_torch.models)
against the JAX package's (repro.models), on the CPU.

Parameters are made by the reference's ``init_params`` and carried
across with ``interop.backbone_params_from_numpy``; inputs come from a
seeded numpy generator.  Configs: ``granite_8b``, ``internlm2_1_8b``,
``qwen1_5_32b`` (qkv biases), ``command_r_35b`` (layernorm, GQA 2),
``mixtral_8x7b`` and ``llama4_maverick_400b_a17b`` (moe) and
``phi_3_vision_4_2b`` (vlm, patch embeddings prepended) SMOKE (f32), plus
variants that switch on what those two leave off —
sliding and chunked masks with a global-layer period, qkv biases,
layernorm, gelu and tied embeddings.  Tolerances: layers atol 1e-5,
rtol 1e-5; backbone atol 1e-5, rtol 1e-4 (f32 sums taken in another
order, compounded over the layers).  The flash path runs the kernel's
plain version here (CPU tensors) and the Pallas kernel in interpret mode
on the reference's side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import backbone as jb
from repro.models import layers as jl
from repro.models.config import NO_SHARDING
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import backbone as tb
from repro_torch.models import layers as tl

torch.set_num_threads(2)

VARIANTS = {
    "granite": {},
    "sliding": dict(attention="sliding", window=48, global_layer_period=2),
    "chunked": dict(attention="chunked", window=64, global_layer_period=2),
    "bias_ln_gelu_tied": dict(qkv_bias=True, norm="layernorm", act="gelu",
                              tie_embeddings=True),
}


def configs(arch, variant, **extra):
    over = dict(VARIANTS[variant], **extra)
    return (dataclasses.replace(jget_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def carried(jcfg, tcfg, seed=0):
    """Reference params (with non-trivial norms and biases) and the port's
    copy of them."""
    params = jb.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        name = getattr(path[-1], "key", "")
        if name in ("scale", "bias", "bq", "bk", "bv"):
            return x + rng.normal(size=x.shape).astype(np.float32) * 0.1
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(jitter, jax.device_get(params))
    return params, interop.backbone_params_from_numpy(tcfg, params)


def unit0(tree):
    return jax.tree.map(lambda x: jnp.asarray(x[0]), tree)


def x_in(b, s, d, seed=1):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def close(port, ref, atol, rtol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["granite", "bias_ln_gelu_tied"])
def test_norm_and_mlp_match(variant):
    jcfg, tcfg = configs("granite_8b", variant)
    params, model = carried(jcfg, tcfg)
    jx, tx = x_in(2, 7, jcfg.d_model)
    p_j, p_t = unit0(params["units"]["mlp"]), model.units[0]["mlp"]
    close(tl.apply_norm(tcfg, p_t.norm, tx), jl.apply_norm(jcfg, p_j["norm"], jx), 1e-5, 1e-5)
    with torch.no_grad():
        close(tl.mlp(tcfg, p_t.w, tx), jl.mlp(jcfg, NO_SHARDING, p_j["w"], jx), 1e-5, 1e-5)


def test_rope_matches():
    jcfg, tcfg = configs("internlm2_1_8b", "granite")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 4, jcfg.hd)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    np.testing.assert_allclose(tl.rope_freqs(tcfg).numpy(), np.asarray(jl.rope_freqs(jcfg)),
                               rtol=1e-6)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jl.rope_freqs(jcfg))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), tl.rope_freqs(tcfg))
    close(got, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("impl", ["naive", "flash", "chunked_q"])
@pytest.mark.parametrize("variant,is_global", [("granite", True), ("sliding", False),
                                               ("chunked", False), ("bias_ln_gelu_tied", True)])
def test_mha_matches(impl, variant, is_global):
    jcfg, tcfg = configs("granite_8b", variant, attn_impl=impl, attn_q_chunk=64)
    params, model = carried(jcfg, tcfg)
    s = 128                                  # flash needs S % 128 == 0
    jx, tx = x_in(2, s, jcfg.d_model, seed=4)
    jpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))
    ref = jl.mha(jcfg, NO_SHARDING, unit0(params["units"]["attn"])["w"], jx, jpos,
                 jl.rope_freqs(jcfg), is_global)
    with torch.no_grad():
        got = tl.mha(tcfg, model.units[0]["attn"].w, tx,
                     torch.arange(s).expand(2, s), tl.rope_freqs(tcfg), is_global)
    close(got, ref, 1e-5, 1e-5)


# -- backbone ------------------------------------------------------------------


@pytest.mark.parametrize("arch,variant", [("granite_8b", "granite"),
                                          ("internlm2_1_8b", "granite"),
                                          ("granite_8b", "sliding"),
                                          ("granite_8b", "bias_ln_gelu_tied"),
                                          ("qwen1_5_32b", "granite"),
                                          ("command_r_35b", "granite"),
                                          ("mixtral_8x7b", "granite"),
                                          ("llama4_maverick_400b_a17b", "granite"),
                                          ("phi_3_vision_4_2b", "granite")])
def test_forward_prefill_decode_match(arch, variant):
    """Mixtral (sliding, window 4) and Llama-4 (chunked, window 4, global
    every 2nd attention layer) route through their moe layers; Phi-3-vision
    prepends its patch embeddings (``extra_embeds``, made as
    tests/test_models.py makes them), and ``pos`` counts them."""
    jcfg, tcfg = configs(arch, variant, window=4)
    params, model = carried(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    b, s = 2, 7
    n_extra = jcfg.num_patch_tokens if jcfg.family == "vlm" else 0
    max_len = 12 + n_extra
    tokens = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()
    extra = jextra = None
    if n_extra:
        extra = (rng.normal(size=(b, n_extra, jcfg.d_model)) * 0.1).astype(np.float32)
        jextra = jnp.asarray(extra)
        extra = torch.from_numpy(extra)
    with torch.no_grad():
        got = tb.forward(tcfg, model, tt, extra)
        assert got.shape == (b, n_extra + s, jcfg.vocab_size)
        close(got, jb.forward(jcfg, NO_SHARDING, params, jnp.asarray(tokens), jextra), 1e-5, 1e-4)
    ref_logits, ref_cache = jb.prefill(jcfg, NO_SHARDING, params, jnp.asarray(tokens), max_len,
                                       jextra)
    logits, cache = tb.prefill(tcfg, model, tt, max_len, extra)
    close(logits, ref_logits, 1e-5, 1e-4)
    close(cache["k"], ref_cache["k"], 1e-5, 1e-4)
    close(cache["v"], ref_cache["v"], 1e-5, 1e-4)
    assert cache["pos"].tolist() == [n_extra + s] * b == [int(ref_cache["pos"])] * b
    for _ in range(3):                       # three decode steps, cache in place
        nxt = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        ref_logits, ref_cache = jb.decode_step(jcfg, NO_SHARDING, params, ref_cache,
                                               jnp.asarray(nxt))
        logits, cache = tb.decode_step(tcfg, model, cache, torch.from_numpy(nxt).long())
        close(logits, ref_logits, 1e-5, 1e-4)
        close(cache["k"], ref_cache["k"], 1e-5, 1e-4)
        close(cache["v"], ref_cache["v"], 1e-5, 1e-4)
        assert cache["pos"].tolist() == [int(ref_cache["pos"])] * b


@pytest.mark.parametrize("batch", [1, 2])
def test_flash_in_model_matches_naive(batch):
    """As tests/test_flash_attention.py::test_flash_in_model_matches_naive:
    the smoke backbone with attn_impl=flash equals naive at S = 128, and
    both equal the reference's flash forward.  Batch 1 is the serve
    engine's prefill, whose folded heads must reach the kernel contiguous."""
    jcfg, tcfg = configs("granite_8b", "granite")
    params, model = carried(jcfg, tcfg, seed=7)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                               (batch, 128)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        naive = tb.forward(tcfg, model, tt)
        flash = tb.forward(dataclasses.replace(tcfg, attn_impl="flash"), model, tt)
    torch.testing.assert_close(flash, naive, atol=5e-5, rtol=1e-3)
    ref = jb.forward(dataclasses.replace(jcfg, attn_impl="flash"), NO_SHARDING, params,
                     jnp.asarray(tokens))
    close(flash, ref, 1e-5, 1e-4)


def test_init_params_distributions_and_device():
    cfg = get_config("granite_8b", smoke=True)
    model = tb.init_params(cfg, torch.Generator().manual_seed(0))
    again = tb.init_params(cfg, torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)     # seeded
    w = model.units[0]["mlp"].w.w_down                       # (d, f): N(0, 1/f)
    assert abs(float(w.detach().std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert abs(float(model.embed.tok.detach().std()) - 0.02) < 0.002
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in model.parameters())
    n_ref = sum(x.size for x in jax.tree.leaves(
        jb.init_params(jget_config("granite_8b", smoke=True), jax.random.PRNGKey(0))))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_unported_families_and_archs_raise():
    """Only the hybrid, ssm and audio families and their archs still raise,
    each naming its ROADMAP item; the moe and vlm configs are the
    reference's, field for field."""
    for family, item in (("hybrid", 12), ("ssm", 13), ("audio", 14)):
        cfg = dataclasses.replace(get_config("granite_8b", smoke=True), family=family)
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
            tb.init_params(cfg, torch.Generator())
    for arch, item in (("hymba_1_5b", 12), ("xlstm_125m", 13), ("whisper_medium", 14)):
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
            get_config(arch)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt2")
    ref = jget_config("granite_8b")
    assert dataclasses.asdict(get_config("granite-8b")) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_config("internlm2_1_8b", smoke=True)) == \
        dataclasses.asdict(jget_config("internlm2_1_8b", smoke=True))
    for arch in ("mixtral_8x7b", "llama4_maverick_400b_a17b", "phi_3_vision_4_2b"):
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
                dataclasses.asdict(jget_config(arch, smoke=smoke)), (arch, smoke)
        assert tb.unit_structure(get_config(arch)) == jb.unit_structure(jget_config(arch))
    assert get_config("mixtral-8x7b").name == "mixtral-8x7b"
