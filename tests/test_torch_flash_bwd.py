"""The port's flash-attention backward (repro_torch.kernels.flash_attention:
the plain dQ/dK/dV formulas and the ``FlashAttention`` autograd Function)
against ``jax.grad`` of the Pallas kernels (repro.kernels.flash_attention,
interpret mode on the CPU).

On the CPU the Function's backward runs the kernels' plain version, so
this file holds that version to the reference: gradients of
``Σ sin(flash(q, k, v))`` for the five mask cases of
tests/test_flash_attention.py at (4, 256, 64), bq = bk = 64, at the
reference's own gradient bar atol 2e-5 + rtol 1e-3 (f32), and a ragged
S = 200 (which the Pallas kernel cannot take) against autograd through
the plain forward.  The rule the CUDA kernels are held to on the card
(``parity.flash_bwd_check``) must fail a backward without ``− delta`` or
with a strict causal mask.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity

torch.set_num_threads(2)

CASES = [
    ("full", 0, True, True),
    ("full", 0, False, True),
    ("sliding", 64, True, False),
    ("sliding", 64, True, True),
    ("chunked", 64, True, False),
]


def mk(n=4, s=256, hd=64, seed=0, count=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, s, hd)) * 0.3).astype(np.float32) for _ in range(count)]


def torch_grads(fn, arrays, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in arrays]
    return torch.autograd.grad(torch.sin(fn(*ts)).sum(), ts)


@pytest.mark.parametrize("attn,win,causal,glob", CASES)
def test_grads_match_pallas(attn, win, causal, glob):
    q, k, v = mk(seed=1)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(FA.flash_attention_nhsd(q, k, v, attn, win, causal, glob,
                                                       bq=64, bk=64, interpret=True)))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = torch_grads(lambda q, k, v: tops.flash_attention_nhsd(q, k, v, attn, win, causal,
                                                                glob), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("attn,win,causal,glob", CASES + [("chunked", 48, False, False)])
def test_plain_bwd_matches_autograd_ragged(attn, win, causal, glob):
    """S = 200: the explicit formulas against autograd through the plain
    forward (the Pallas kernel needs S divisible by its block)."""
    arrays = mk(n=3, s=200, hd=64, seed=2)
    got = torch_grads(lambda q, k, v: TF.FlashAttention.apply(q, k, v, attn, win, causal,
                                                              glob), arrays)
    want = torch_grads(lambda q, k, v: TF.flash_attention_plain(q, k, v, attn, win, causal,
                                                                glob)[0], arrays)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-3)


def test_grads_keep_bf16_and_take_strided_grad():
    """bf16 inputs get bf16 gradients; a non-contiguous upstream gradient
    (the model's head transpose) is taken."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
               for x in mk(n=4, s=128, hd=16, seed=3))
    o = tops.flash_attention_nhsd(q, k, v)
    o4 = o.reshape(2, 2, 128, 16).transpose(1, 2)       # (b, s, h, hd) view
    up = torch.from_numpy(mk(n=2, s=128, hd=32, seed=4, count=1)[0]).reshape(2, 128, 2, 16)
    grads = torch.autograd.grad(o4, (q, k, v), up.to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    o32, lse = TF.flash_attention_plain(q.detach().float(), k.detach().float(),
                                        v.detach().float())
    do = up.transpose(1, 2).reshape(4, 128, 16).contiguous()
    want = TF.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o.detach(), lse, do.to(torch.bfloat16))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _mutant_bwd(q, k, v, o, lse, do, drop_delta=False, strict=False):
    """The plain formulas with one mutation (causal mask only)."""
    s, hd = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(s)
    mask = (pos[None, :] < pos[:, None]) if strict else (pos[None, :] <= pos[:, None])
    p = torch.where(mask, torch.exp(torch.einsum("nqd,nkd->nqk", q, k) * scale - lse[..., None]),
                    torch.zeros(()))
    delta = 0.0 if drop_delta else TF.flash_delta(o, do)[..., None]
    ds = p * (torch.einsum("nqd,nkd->nqk", do, v) - delta)
    return (torch.einsum("nqk,nkd->nqd", ds, k) * scale,
            torch.einsum("nqk,nqd->nkd", ds, q) * scale, torch.einsum("nqk,nqd->nkd", p, do))


def test_flash_bwd_check_rule_bites():
    q, k, v, do = (torch.from_numpy(x) for x in mk(n=2, s=128, hd=64, seed=5, count=4))
    o, lse = TF.flash_attention_plain(q, k, v)
    ref = TF.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert parity.flash_bwd_check(*ref, *ref).ok
    assert parity.flash_bwd_check(*_mutant_bwd(q, k, v, o, lse, do), *ref).ok
    assert parity.flash_bwd_check(*(g.to(torch.bfloat16) for g in ref), *ref).ok
    no_delta = parity.flash_bwd_check(*_mutant_bwd(q, k, v, o, lse, do, drop_delta=True), *ref)
    assert no_delta.bad["dq"] > 0 and no_delta.bad["dk"] > 0, no_delta
    strict = parity.flash_bwd_check(*_mutant_bwd(q, k, v, o, lse, do, strict=True), *ref)
    assert not strict.ok, strict
    off = ref[0].clone()
    off[1, 5, 3] += 3e-5 + 2e-3 * abs(float(off[1, 5, 3]))
    assert parity.flash_bwd_check(off, *ref[1:], *ref).bad == {"dq": 1, "dk": 0, "dv": 0}
