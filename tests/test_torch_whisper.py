"""The port's audio family (Whisper: an encoder over frame embeddings and a
decoder with cross-attention, ``repro_torch.models.backbone``) against the
JAX package's, on the CPU.

Config: ``whisper_medium`` SMOKE (f32, 2 + 2 layers, d 64, 4 heads, hd 16,
``encoder_seq`` 32).  The reference's params are carried across with
``interop``; every leaf that the reference initializes at zero or one
(``enc_pos``, every layernorm's scale and bias) is first perturbed by
seeded noise, so that a dropped ``enc_pos`` add, norm scale or norm bias
fails.  Inputs (tokens, frames (B, encoder_seq, d) × 0.1, as
``tests/test_models.py`` makes them) come from seeded numpy generators.

Tolerances: layers atol 1e-5, rtol 1e-5; the backbone (logits, caches)
atol 1e-5, rtol 1e-4 (f32 sums taken in another order, compounded over
the layers); decode against the forward atol 5e-5, rtol 1e-3, the
reference's own rule (``tests/test_models.py::test_decode_matches_forward``);
``train_step`` under ``tests/test_torch_token_dqn.py``'s rules
(``check_step``).  The flash arm (128 decoder tokens, ``encoder_seq`` 128)
runs the reference's Pallas kernels in interpret mode, causal in the
decoder and non-causal in the encoder, and the kernels' plain version on
the port's side.
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
from repro.models.config import NO_SHARDING
from repro.serve.engine import BucketSpec as JBucketSpec
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro_torch import interop, serve_actor
from repro_torch.agents import token_dqn as tdqn
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import backbone as tb
from repro_torch.models import layers as tl
from repro_torch.serve import ActorServeConfig, ActorServer
from test_torch_token_dqn import _batch, check_step  # noqa: E402 — sibling test module

torch.set_num_threads(2)

ARCH = "whisper_medium"
JITTERED = ("enc_pos", "scale", "bias")


def configs(**over):
    return (dataclasses.replace(jget_config(ARCH, smoke=True), **over),
            dataclasses.replace(get_config(ARCH, smoke=True), **over))


def jittered(tree, seed):
    """``tree`` (numpy leaves) with seeded noise added to every ``JITTERED``
    leaf."""
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", "") in JITTERED:
            return x + rng.normal(size=x.shape).astype(x.dtype) * 0.1
        return x

    return jax.tree_util.tree_map_with_path(jitter, jax.device_get(tree))


def carried(jcfg, tcfg, seed=0):
    params = jittered(jb.init_params(jcfg, jax.random.PRNGKey(seed)), seed + 100)
    return params, interop.backbone_params_from_numpy(tcfg, params)


def inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return tokens, frames


def close(port, ref, atol, rtol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def close_caches(cache, ref_cache):
    assert set(cache) == set(ref_cache) == {"pos", "k", "v", "cross_k", "cross_v"}
    for key in ("k", "v", "cross_k", "cross_v"):
        assert cache[key].shape == ref_cache[key].shape, key
        close(cache[key], ref_cache[key], 1e-5, 1e-4)
    assert cache["pos"].tolist() == [int(ref_cache["pos"])] * cache["pos"].shape[0]


def test_params_as_the_references():
    """``init_params`` builds the reference's tree: every reference leaf has
    its port parameter of the same shape (one module a layer where the
    reference stacks 2 + 2), the same count at SMOKE and at full size
    (960,865,280, counted with ``jax.eval_shape`` on the reference's side
    and on the meta device here), seeded, ``enc_pos`` at zero."""
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    model = tb.init_params(cfg, torch.Generator().manual_seed(0))
    again = tb.init_params(cfg, torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    names = [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert interop.backbone_leaf(ref, name).shape == p.shape, name
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.asarray(x).size for x in jax.tree.leaves(ref))
    assert len(model.enc_units) == len(model.dec_units) == 2
    assert set(model.enc_units[0]) == {"attn_nc", "mlp"}
    assert set(model.dec_units[0]) == {"attn", "cross", "mlp"}
    assert not model.enc_pos.any() and model.embed.out is None          # tied
    assert "enc_pos" in names and "enc_norm.bias" in names
    full = get_config(ARCH)
    n_ref = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
        lambda: jb.init_params(jget_config(ARCH), jax.random.PRNGKey(0)))))
    meta = tb.Backbone(full, "meta")
    assert sum(p.numel() for p in meta.parameters()) == n_ref == 960_865_280
    assert meta.enc_pos.dtype == torch.bfloat16 and meta.enc_pos.shape == (1500, 1024)


@pytest.mark.parametrize("impl", ["naive", "chunked_q"])
def test_forward_matches_reference(impl):
    jcfg, cfg = configs(attn_impl=impl, attn_q_chunk=4)
    params, model = carried(jcfg, cfg)
    tokens, frames = inputs(jcfg, 2, 12, seed=1)
    ref = jb.forward(jcfg, NO_SHARDING, params, jnp.asarray(tokens), jnp.asarray(frames))
    with torch.no_grad():
        got = tb.forward(cfg, model, torch.from_numpy(tokens).long(), torch.from_numpy(frames))
    assert got.shape == (2, 12, jcfg.vocab_size)
    close(got, ref, 1e-5, 1e-4)
    with pytest.raises(ValueError, match="frame embeddings"):
        tb.forward(cfg, model, torch.from_numpy(tokens).long())


@pytest.mark.parametrize("impl", ["naive", "chunked_q"])
@pytest.mark.parametrize("causal,use_rope", [(False, True), (True, True), (True, False)])
def test_cross_attention_matches_reference(impl, causal, use_rope):
    """``mha`` with ``kv_override``: q alone is projected (and rotated only
    where causal and ``use_rope``, as the reference rotates it), the keys
    sit at positions 0..Sk-1 and are never rotated, the path is naive or
    chunked-query; against ``repro.models.layers.mha``."""
    jcfg, cfg = configs(attn_impl=impl, attn_q_chunk=4)
    params, model = carried(jcfg, cfg, seed=2)
    rng = np.random.default_rng(3)
    b, s, sk = 2, 8, jcfg.encoder_seq
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, jcfg.num_kv_heads, jcfg.hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + 5, (b, s))
    w = jax.tree.map(lambda a: jnp.asarray(a[0]), params["dec_units"]["cross"]["w"])
    ref = jl.mha(jcfg, NO_SHARDING, w, jnp.asarray(x), jnp.asarray(pos), jl.rope_freqs(jcfg),
                 True, kv_override=(jnp.asarray(k), jnp.asarray(v)), causal=causal,
                 use_rope=use_rope)
    with torch.no_grad():
        got = tl.mha(cfg, model.dec_units[0]["cross"].w, torch.from_numpy(x),
                     torch.from_numpy(pos.copy()).long(), tl.rope_freqs(cfg), True,
                     causal=causal, use_rope=use_rope,
                     kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    close(got, ref, 1e-5, 1e-5)


def test_prefill_and_decode_match_reference():
    """``prefill`` (the encoder and the decoder once each) against the
    reference's (each twice): logits, every layer's self K/V and cross K/V,
    ``pos``; then two ``decode_step``s against the reference's (logits and
    caches), and each step's logits against the reference's own forward
    over the prompt and the fed tokens under its decode↔forward rule."""
    jcfg, cfg = configs()
    params, model = carried(jcfg, cfg, seed=4)
    tokens, frames = inputs(jcfg, 2, 9, seed=5)
    prompt, fed, max_len = tokens[:, :7], tokens[:, 7:], 16
    jfr, tfr = jnp.asarray(frames), torch.from_numpy(frames)
    ref_logits, ref_cache = jb.prefill(jcfg, NO_SHARDING, params, jnp.asarray(prompt), max_len,
                                       jfr)
    logits, cache = tb.prefill(cfg, model, torch.from_numpy(prompt).long(), max_len, tfr)
    assert logits.shape == (2, 7, jcfg.vocab_size)
    close(logits, ref_logits, 1e-5, 1e-4)
    close_caches(cache, ref_cache)
    assert cache["pos"].tolist() == [7, 7]
    forward = jb.forward(jcfg, NO_SHARDING, params, jnp.asarray(tokens), jfr)
    for t in range(2):
        nxt = fed[:, t:t + 1]
        ref_logits, ref_cache = jb.decode_step(jcfg, NO_SHARDING, params, ref_cache,
                                               jnp.asarray(nxt))
        logits, cache = tb.decode_step(cfg, model, cache, torch.from_numpy(nxt).long())
        close(logits, ref_logits, 1e-5, 1e-4)
        close_caches(cache, ref_cache)
        close(logits[:, 0], forward[:, 7 + t], 5e-5, 1e-3)


def test_train_step_matches_reference():
    """One ``train_step`` (accum 2, as the reference's
    ``tests/test_models.py::test_smoke_train_step``; remat on, the
    config's default) with frames in the batch: the loss, grad norm, Q
    mean, the new priorities, every parameter, the target and the Adam
    moments, under ``check_step``'s rules."""
    jcfg, cfg = configs()
    tcfg_j = jdqn.TokenDQNConfig(accum=2)
    jstate = jdqn.init_train_state(jcfg, tcfg_j, jax.random.PRNGKey(3))
    target = jittered(jdqn.init_train_state(jcfg, tcfg_j, jax.random.PRNGKey(4)).params, 7)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, jittered(jstate.params, 6)),
                             target=jax.tree.map(jnp.asarray, target))
    batch = _batch(jcfg)
    batch["extra_embeds"] = inputs(jcfg, 4, 1, seed=8)[1]
    jnew, jmetrics, jtds = jdqn.train_step(jcfg, NO_SHARDING, tcfg_j, jstate,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    check_step(cfg, tdqn.TokenDQNConfig(accum=2), jstate, batch, jnew, jmetrics, jtds)


def test_batched_decode_with_per_row_pos_equals_batch1():
    """Two prompts of 5 and 8 tokens, each prefilled alone behind its own
    frames, their caches stacked into one batch (``pos`` 5 and 8): three
    batched decode steps, the second with ``write_mask`` [True, False],
    give each row the logits of its own batch-1 decodes (row 1 skips the
    masked step), and leave the masked row's K/V entry and ``pos`` as they
    were."""
    cfg = get_config(ARCH, smoke=True)
    model = tb.init_params(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.enc_pos.normal_(generator=torch.Generator().manual_seed(2))
    tokens, frames = inputs(cfg, 2, 8, seed=9)
    tokens, frames = torch.from_numpy(tokens).long(), torch.from_numpy(frames)
    lens, max_len = (5, 8), 16
    solo = [tb.prefill(cfg, model, tokens[i:i + 1, :n], max_len, frames[i:i + 1])[1]
            for i, n in enumerate(lens)]
    cache = {key: torch.cat([c[key] for c in solo], dim=0 if key == "pos" else 1).clone()
             for key in solo[0]}
    assert cache["pos"].tolist() == list(lens)
    steps = torch.tensor([[[3], [7]], [[11], [13]], [[17], [19]]])
    masks = [None, torch.tensor([True, False]), None]
    for nxt, mask in zip(steps, masks):
        before = cache["k"][:, 1].clone()
        logits, cache = tb.decode_step(cfg, model, cache, nxt, mask)
        for i in range(2):
            if mask is not None and not mask[i]:
                assert torch.equal(cache["k"][:, 1], before)
                continue
            want, solo[i] = tb.decode_step(cfg, model, solo[i], nxt[i:i + 1])
            torch.testing.assert_close(logits[i], want[0], atol=1e-6, rtol=1e-5)
    assert cache["pos"].tolist() == [lens[0] + 3, lens[1] + 2]
    for key in ("k", "v", "cross_k", "cross_v"):
        for i in range(2):
            torch.testing.assert_close(cache[key][:, i], solo[i][key][:, 0], atol=1e-6,
                                       rtol=1e-5)


def test_flash_launches_per_prefill(monkeypatch):
    """The decoder's layers at a prompt that is a multiple of 128, and the
    encoder's where ``encoder_seq`` is: 24 for Whisper-medium (1,500
    frames take the naive path), 2 + 2 at SMOKE with 128 frames, 2 with 32;
    one flash call a counted layer in a prefill (here the kernel's plain
    version, called through ``ops.flash_attention_nhsd``)."""
    assert tb.flash_launches_per_prefill(get_config(ARCH)) == 24
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_impl="flash")
    assert tb.flash_launches_per_prefill(cfg) == 2
    cfg = dataclasses.replace(cfg, encoder_seq=128)
    assert tb.flash_launches_per_prefill(cfg) == 4
    calls = []
    real = ops.flash_attention_nhsd
    monkeypatch.setattr(ops, "flash_attention_nhsd",
                        lambda q, *a: calls.append((q.shape, a[4])) or real(q, *a))
    model = tb.init_params(cfg, torch.Generator().manual_seed(3))
    tokens, frames = inputs(cfg, 2, 128, seed=10)
    tb.prefill(cfg, model, torch.from_numpy(tokens).long(), 136, torch.from_numpy(frames))
    assert len(calls) == tb.flash_launches_per_prefill(cfg)
    assert sorted(c for _, c in calls) == [False, False, True, True]   # encoder, decoder


def test_flash_arm_matches_reference():
    """``attn_impl="flash"`` at 128 decoder tokens and 128 frames: the
    encoder's non-causal and the decoder's causal self-attention take the
    flash path on both sides (the reference's Pallas kernels in interpret
    mode, the port's plain version), cross-attention the naive one; the
    logits against the reference's, and against the port's naive arm."""
    jcfg, cfg = configs(attn_impl="flash", encoder_seq=128)
    params, model = carried(jcfg, cfg, seed=11)
    tokens, frames = inputs(jcfg, 2, 128, seed=12)
    ref = jb.forward(jcfg, NO_SHARDING, params, jnp.asarray(tokens), jnp.asarray(frames))
    tt, tfr = torch.from_numpy(tokens).long(), torch.from_numpy(frames)
    with torch.no_grad():
        flash = tb.forward(cfg, model, tt, tfr)
        naive = tb.forward(dataclasses.replace(cfg, attn_impl="naive"), model, tt, tfr)
    close(flash, ref, 1e-5, 1e-4)
    torch.testing.assert_close(flash, naive, atol=5e-5, rtol=1e-3)


def test_remat_gradients_bit_for_bit():
    """Remat on against off: the TD loss and every gradient bit for bit
    (one thread), with both stacks checkpointed: each attention layer's
    ``mha_kv`` (cross-attention's too) runs twice with remat and once
    without."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config(ARCH, smoke=True)
        model = tb.init_params(cfg, torch.Generator().manual_seed(4))
        target = tb.init_params(cfg, torch.Generator().manual_seed(5)).requires_grad_(False)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, b=2, s=64, seed=13).items()}
        batch["extra_embeds"] = torch.from_numpy(inputs(cfg, 2, 1, seed=14)[1])
        out = {}
        real = tl.mha_kv
        for remat in (True, False):
            c = dataclasses.replace(cfg, remat=remat)
            calls = []
            tl.mha_kv = lambda *a, **k: calls.append(1) or real(*a, **k)
            try:
                loss, _ = tdqn._td_loss(c, tdqn.TokenDQNConfig(), model, target, batch)
                grads = torch.autograd.grad(loss, list(model.parameters()))
            finally:
                tl.mha_kv = real
            out[remat] = (loss.detach(), grads, len(calls))
    finally:
        torch.set_num_threads(before)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)
    # 2 + 2 self-attention (encoder, decoder) and 2 cross layers, online and
    # target; the backward runs the online network's 6 again with remat
    assert (out[False][2], out[True][2]) == (12, 18)


def test_whisper_is_not_servable():
    """The continuous-batching engine refuses the audio family with the
    reference's error, as ``repro.serve`` does (``SUPPORTED_FAMILIES``
    stays ("dense", "moe")); ``serve_actor`` exits 2."""
    jcfg, cfg = configs()
    with pytest.raises(ValueError) as ref:
        JDecodeEngine(jcfg, slots=2, max_len=12, buckets=JBucketSpec((4,)))
    model = tb.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as got:
        ActorServer(cfg, model, ActorServeConfig(slots=2, max_len=12, buckets=(4,)),
                    device="cpu")
    assert str(got.value) == str(ref.value) and "'audio'" in str(got.value)
    assert serve_actor.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu"]) == 2
