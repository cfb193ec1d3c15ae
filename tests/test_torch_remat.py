"""Remat in the port's backbone (``ModelConfig.remat``): each unit under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of each
unit, on the CPU.

At InternLM2-1.8B and Granite-8B SMOKE (f32), naive and flash attention
(the flash kernel's plain version here), one TD loss and its gradients
with remat on against off: bit for bit.  The backward really runs each
unit's forward again: every attention layer's ``mha_kv`` is called twice
in a forward and backward with remat and once without.  The gradients
against the reference's ``jax.grad`` of its own TD loss with
``remat=True`` on the same weights and batch, within the tolerance that
``tests/test_torch_token_dqn.py`` holds the Adam moments to (which carry
these gradients): rtol 1e-4 plus an atol of 1e-5 of the tensor's largest
magnitude, the loss at rtol 1e-5.  A no-grad forward and ``prefill``
take no checkpoint and give the same logits and cache bit for bit.

One intra-op thread: torch's CPU backward is not bit-reproducible from
run to run with two (its reductions split differently), and bit for bit
is what is compared here.
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
from repro.models.config import NO_SHARDING
from repro_torch import interop
from repro_torch.agents import token_dqn as tdqn
from repro_torch.configs import get_config
from repro_torch.models import backbone as tb
from repro_torch.models import layers as tl

ARCHS = ["internlm2_1_8b", "granite_8b"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(vocab, b=2, s=128, seed=0):
    rng = np.random.default_rng(seed)
    dones = np.zeros((b, s), np.float32)
    dones[:, 63] = 1.0
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "actions": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "rewards": rng.uniform(0, 1, (b, s)).astype(np.float32),
            "dones": dones,
            "is_weights": rng.uniform(0.5, 1.0, b).astype(np.float32)}


def _setup(arch, impl, seed=0):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), attn_impl=impl, remat=True)
    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_impl=impl, remat=True)
    jparams = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(seed)))
    jtarget = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(seed + 1)))
    model = interop.backbone_params_from_numpy(cfg, jparams)
    target = interop.backbone_params_from_numpy(cfg, jtarget).requires_grad_(False)
    return jcfg, cfg, jparams, jtarget, model, target


def _grads(cfg, model, target, batch):
    tb_ = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = tdqn._td_loss(cfg, tdqn.TokenDQNConfig(), model, target, tb_)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def _counting_mha_kv(monkeypatch):
    calls = []
    real = tl.mha_kv

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(tl, "mha_kv", counted)
    return calls


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bit_for_bit_and_recomputed(arch, impl, monkeypatch):
    _, cfg, _, _, model, target = _setup(arch, impl)
    batch = _batch(cfg.vocab_size)
    calls = _counting_mha_kv(monkeypatch)
    out = {}
    for remat in (True, False):
        calls.clear()
        out[remat] = _grads(dataclasses.replace(cfg, remat=remat), model, target, batch)
        out[remat] += (list(calls),)
    layers = cfg.num_layers
    # the online forward (grad), the target's (no grad), and with remat the
    # backward's recompute of every unit
    assert out[True][2].count(True) == 2 * layers and out[True][2].count(False) == layers
    assert out[False][2].count(True) == layers and out[False][2].count(False) == layers
    assert torch.equal(out[True][0], out[False][0])
    for name, a, b in zip((n for n, _ in model.named_parameters()), out[True][1],
                          out[False][1], strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_reference(arch, impl):
    jcfg, cfg, jparams, jtarget, model, target = _setup(arch, impl, seed=2)
    batch = _batch(cfg.vocab_size, seed=3)
    loss, grads = _grads(cfg, model, target, batch)
    jtcfg = jdqn.TokenDQNConfig()

    def jloss(p):
        return jdqn._td_loss(jcfg, jtcfg, p, jtarget, NO_SHARDING,
                             {k: jnp.asarray(v) for k, v in batch.items()})[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jg = jax.device_get(jg)
    for (name, _), got in zip(model.named_parameters(), grads, strict=True):
        want = interop.backbone_leaf(jg, name).astype(np.float64)
        np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_grad_forward_and_prefill_unchanged(arch, monkeypatch):
    _, cfg, _, _, model, _ = _setup(arch, "flash")
    tokens = torch.from_numpy(_batch(cfg.vocab_size)["tokens"]).long()
    calls = _counting_mha_kv(monkeypatch)
    off = dataclasses.replace(cfg, remat=False)
    with torch.no_grad():
        a, b = tb.forward(cfg, model, tokens), tb.forward(off, model, tokens)
    assert torch.equal(a, b)
    (la, ca), (lb, cb) = tb.prefill(cfg, model, tokens, 160), tb.prefill(off, model, tokens, 160)
    assert torch.equal(la, lb) and all(torch.equal(ca[k], cb[k]) for k in ca)
    # one call per attention layer in each of the four, never a recompute
    assert calls == [False] * (4 * cfg.num_layers)
