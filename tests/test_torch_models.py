"""The port's token-model layers and dense backbone (repro_torch.models)
against the JAX package's (repro.models), on the CPU.

Parameters are made by the reference's ``init_params`` and carried
across with ``interop.backbone_params_from_numpy``; inputs come from a
seeded numpy generator.  Configs: ``granite_8b``, ``internlm2_1_8b``,
``qwen1_5_32b`` (qkv biases), ``command_r_35b`` (layernorm, GQA 2),
``mixtral_8x7b`` and ``llama4_maverick_400b_a17b`` (moe),
``phi_3_vision_4_2b`` (vlm, patch embeddings prepended), ``hymba_1_5b``
(hybrid: attention and SSM heads; a 256-token prompt, two SSM chunks, past
its window of 32), ``xlstm_125m`` (ssm: mLSTM and sLSTM blocks) and
``whisper_medium`` (audio: encoder, decoder and cross-attention; its
dedicated tests are ``tests/test_torch_whisper.py``) SMOKE (f32), plus
variants that switch on what those two leave off —
sliding and chunked masks with a global-layer period, qkv biases,
layernorm, gelu and tied embeddings.  Tolerances: layers atol 1e-5,
rtol 1e-5; backbone atol 1e-5, rtol 1e-4 (f32 sums taken in another
order, compounded over the layers), Hymba's 256-token prompt atol 5e-5
(its SSM sums 128 decays and products a chunk in another order: 1.9e-5
measured on logits of magnitude ~5).  The flash path runs the kernel's
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
                                          ("phi_3_vision_4_2b", "granite"),
                                          ("hymba_1_5b", "granite"),
                                          ("xlstm_125m", "granite"),
                                          ("whisper_medium", "granite")])
def test_forward_prefill_decode_match(arch, variant):
    """Mixtral (sliding, window 4) and Llama-4 (chunked, window 4, global
    every 2nd attention layer) route through their moe layers; Phi-3-vision
    prepends its patch embeddings (``extra_embeds``, made as
    tests/test_models.py makes them), and ``pos`` counts them.  Hymba keeps
    its window of 32 and prefills 256 tokens, so its SSM crosses a chunk
    boundary and its local layer masks; its cache holds each unit's SSM
    state, xLSTM's each block's recurrent state.  Whisper encodes its
    frames (``extra_embeds``, which do not count in ``pos``) and caches
    each decoder layer's cross K/V."""
    hymba = arch == "hymba_1_5b"
    jcfg, tcfg = configs(arch, variant, **({} if hymba else {"window": 4}))
    params, model = carried(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    b, s = 2, 256 if hymba else 7
    atol = 5e-5 if hymba else 1e-5
    n_extra = jcfg.num_patch_tokens if jcfg.family == "vlm" else 0
    max_len = s + 5 + n_extra
    tokens = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()
    extra = jextra = None
    n_embeds = jcfg.encoder_seq if jcfg.family == "audio" else n_extra
    if n_embeds:
        extra = (rng.normal(size=(b, n_embeds, jcfg.d_model)) * 0.1).astype(np.float32)
        jextra = jnp.asarray(extra)
        extra = torch.from_numpy(extra)
    with torch.no_grad():
        got = tb.forward(tcfg, model, tt, extra)
        assert got.shape == (b, n_extra + s, jcfg.vocab_size)
        close(got, jb.forward(jcfg, NO_SHARDING, params, jnp.asarray(tokens), jextra), atol, 1e-4)
    ref_logits, ref_cache = jb.prefill(jcfg, NO_SHARDING, params, jnp.asarray(tokens), max_len,
                                       jextra)
    logits, cache = tb.prefill(tcfg, model, tt, max_len, extra)
    close(logits, ref_logits, atol, 1e-4)
    close_caches(cache, ref_cache, atol)
    assert cache["pos"].tolist() == [n_extra + s] * b == [int(ref_cache["pos"])] * b
    for _ in range(3):                       # three decode steps, cache in place
        nxt = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        ref_logits, ref_cache = jb.decode_step(jcfg, NO_SHARDING, params, ref_cache,
                                               jnp.asarray(nxt))
        logits, cache = tb.decode_step(tcfg, model, cache, torch.from_numpy(nxt).long())
        close(logits, ref_logits, atol, 1e-4)
        close_caches(cache, ref_cache, atol)
        assert cache["pos"].tolist() == [int(ref_cache["pos"])] * b


def close_caches(cache, ref_cache, atol):
    """K/V (and a hybrid model's SSM states, an audio model's cross K/V) or
    an ssm model's block states, against the reference's cache (the
    tolerance of the backbone)."""
    assert set(cache) == set(ref_cache)
    for key in ("k", "v", "ssm", "cross_k", "cross_v"):
        if key in cache:
            close(cache[key], ref_cache[key], atol, 1e-4)
    for blk, ref_blk in zip(cache.get("blocks", []), ref_cache.get("blocks", []), strict=True):
        (kind, state), = blk.items()
        for field, a, want in zip(state._fields, state, ref_blk[kind], strict=True):
            close(a, want, atol, 1e-4)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_125m"])
def test_bf16_rounding_as_the_references(arch):
    """The hybrid and ssm families' bf16 logits lie far from their f32 ones
    (at 8 layers of SMOKE width ~5 % and ~8 % relative l2, where the dense
    family's stay near 1 %), in the reference as in the port: on the same
    bf16-representable weights and 2 × 128 tokens, the port's bf16-vs-f32
    distance is within 25 % of the reference's (0.985× and 0.936×
    measured).  ``chip_smoke.py`` phase 24 sets its bf16 rules from this."""
    jf, tf = configs(arch, "granite", num_layers=8)
    jbf, tbf = (dataclasses.replace(c, dtype="bfloat16") for c in (jf, tf))
    params = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)),
        jax.device_get(jb.init_params(jf, jax.random.PRNGKey(0))))
    pj_bf = jax.tree.map(lambda like, x: jnp.asarray(x).astype(like.dtype),
                         jb.init_params(jbf, jax.random.PRNGKey(0)), params)
    tokens = np.random.default_rng(1).integers(0, jf.vocab_size, (2, 128)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(((a - b) ** 2).sum() / (b ** 2).sum()))

    ref = rel(np.asarray(jb.forward(jbf, NO_SHARDING, pj_bf, jnp.asarray(tokens)), np.float32),
              jb.forward(jf, NO_SHARDING, jax.tree.map(jnp.asarray, params), jnp.asarray(tokens)))
    with torch.no_grad():
        f32 = tb.forward(tf, interop.backbone_params_from_numpy(tf, params), tt)
        bf16 = tb.forward(tbf, interop.backbone_params_from_numpy(tbf, params), tt)
    port = rel(bf16.float(), f32)
    assert ref > 0.03, ref                   # the families' bf16 sensitivity
    assert abs(port / ref - 1.0) <= 0.25, (port, ref)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_125m"])
def test_write_mask_holds_back_recurrent_state(arch):
    """A decode step with ``write_mask`` [True, False]: row 0 advances as
    an unmasked step does; row 1's K/V entry, SSM or block states and
    ``pos`` stay exactly as they were."""
    cfg = get_config(arch, smoke=True)
    model = tb.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))
    nxt = torch.tensor([[3], [5]])
    _, cache = tb.prefill(cfg, model, tokens, 12)
    before = {k: [t.clone() for t in leaves(v)] for k, v in cache.items()}
    _, full = tb.prefill(cfg, model, tokens, 12)
    want, full = tb.decode_step(cfg, model, full, nxt)
    got, cache = tb.decode_step(cfg, model, cache, nxt, torch.tensor([True, False]))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert cache["pos"].tolist() == [9, 8]
    moved = 0
    for key, old in before.items():
        bdim = 0 if key in ("pos", "blocks") else 1      # k, v, ssm: (layers, B, ...)
        for t_old, t_new, t_full in zip(old, leaves(cache[key]), leaves(full[key]), strict=True):
            assert torch.equal(t_new.select(bdim, 1), t_old.select(bdim, 1)), key
            assert torch.equal(t_new.select(bdim, 0), t_full.select(bdim, 0)), key
            moved += not torch.equal(t_new.select(bdim, 0), t_old.select(bdim, 0))
    assert moved > 0


def leaves(x):
    """The tensors of a cache entry: itself, or a block list's states."""
    if torch.is_tensor(x):
        return [x]
    return [t for blk in x for state in blk.values() for t in state]


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
    """Every family and arch of the reference is ported: a family or an
    arch it does not have raises; the moe, vlm and audio configs are the
    reference's, field for field."""
    cfg = dataclasses.replace(get_config("granite_8b", smoke=True), family="conv")
    with pytest.raises(ValueError, match="unknown family 'conv'"):
        tb.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt2")
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("whisper_medium", smoke=smoke)) == \
            dataclasses.asdict(jget_config("whisper_medium", smoke=smoke)), smoke
    assert get_config("whisper-medium") == get_config("whisper_medium")
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


@pytest.mark.parametrize("arch,alias", [("hymba_1_5b", "hymba-1.5b"),
                                        ("xlstm_125m", "xlstm-125m")])
def test_hybrid_and_ssm_configs_and_params(arch, alias):
    """The hybrid and ssm configs are the reference's, field for field (the
    published and the SMOKE one); ``init_params`` builds the families with
    the reference's parameter count and names (every reference leaf has
    its port parameter), seeded, on the CPU, in the config's dtypes."""
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jget_config(arch, smoke=smoke)), (arch, smoke)
    assert get_config(alias).name == jget_config(arch).name
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    model = tb.init_params(cfg, torch.Generator().manual_seed(0))
    again = tb.init_params(cfg, torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.asarray(x).size for x in jax.tree.leaves(ref))
    for name, p in model.named_parameters():
        assert interop.backbone_leaf(ref, name).shape == p.shape, name
    if cfg.family == "hybrid":
        assert tb.unit_structure(cfg) == jb.unit_structure(jcfg) == (("hybrid", "mlp"), 2)
        ssm = model.units[0]["hybrid"].ssm
        assert ssm.A_log.dtype == torch.float32 and not ssm.A_log.any()
        assert tb.flash_launches_per_prefill(get_config(arch)) == 32
    else:
        assert [next(k for k in blk if k not in ("norm", "mlp")) for blk in model.blocks] == \
            ["mlstm", "slstm", "mlstm"]
        assert model.blocks[1]["mlp"].w.w_up.shape == (64 * 4 // 3, 64)
        assert model.blocks[1]["slstm"].rz.shape == (2, 32, 32)
        assert model.embed.out is None                       # tied embeddings
        assert tb.flash_launches_per_prefill(get_config(arch)) == 0
