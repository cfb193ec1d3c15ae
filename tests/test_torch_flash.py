"""The port's flash-attention forward (repro_torch.kernels.flash_attention)
against the Pallas kernel (repro.kernels.flash_attention, interpret mode
on the CPU).

On the CPU the wrapper runs the plain version, so this file holds the
plain version to the reference: O against ``flash_attention_nhsd`` and
the row LSE against ``_fwd``, for the five mask cases of
tests/test_flash_attention.py and a block sweep, at the reference's own
bar atol 2e-6, rtol 1e-4 (f32).  The CUDA kernel is held to the plain
version on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

CASES = [
    ("full", 0, True, True),
    ("full", 0, False, True),
    ("sliding", 64, True, False),
    ("sliding", 64, True, True),
    ("chunked", 64, True, False),
]


def mk(n=4, s=256, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, s, hd)) * 0.3).astype(np.float32) for _ in range(3)]


def check(q, k, v, attn, win, causal, glob, bq, bk):
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_o = FA.flash_attention_nhsd(jq, jk, jv, attn, win, causal, glob,
                                    bq=bq, bk=bk, interpret=True)
    _, ref_lse = FA._fwd(jq, jk, jv, jnp.asarray([int(glob)], jnp.int32), attn,
                         win, causal, bq, bk, True)
    o, lse = TF.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), attn, win,
                                    causal, glob)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=2e-6, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-6, rtol=1e-4)
    np.testing.assert_array_equal(
        tops.flash_attention_nhsd(*map(torch.from_numpy, (q, k, v)), attn, win,
                                  causal, glob).numpy(), o.numpy())


@pytest.mark.parametrize("attn,win,causal,glob", CASES)
def test_plain_matches_pallas_masks(attn, win, causal, glob):
    check(*mk(), attn, win, causal, glob, 64, 64)


@pytest.mark.parametrize("s,hd,bq,bk", [(128, 16, 128, 64), (384, 128, 128, 128)])
def test_plain_matches_pallas_block_sweep(s, hd, bq, bk):
    check(*mk(n=2, s=s, hd=hd, seed=s + hd), "full", 0, True, True, bq, bk)


def test_plain_bf16_keeps_dtype_and_f32_lse():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in mk(n=2, s=128, hd=16))
    o, lse = TF.flash_attention_fwd(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o32, lse32 = TF.flash_attention_fwd(q.float(), k.float(), v.float())
    torch.testing.assert_close(lse, lse32, rtol=0, atol=0)
    torch.testing.assert_close(o, o32.to(torch.bfloat16), rtol=0, atol=0)


def test_wrapper_refuses_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in mk(n=1, s=128, hd=16))
    with pytest.raises(ValueError, match="window >= 1"):
        tops.flash_attention_nhsd(q, k, v, "chunked", 0)
    with pytest.raises(ValueError, match="attention must be"):
        tops.flash_attention_nhsd(q, k, v, "local")
    # the meta device (the dry run) takes the stand-in: shapes, no values
    o = tops.flash_attention_nhsd(q.to("meta"), k.to("meta"), v.to("meta"))
    assert o.device.type == "meta" and o.shape == q.shape and o.dtype == q.dtype
    with pytest.raises(ValueError, match="attention must be"):
        tops.flash_attention_nhsd(q.to("meta"), k.to("meta"), v.to("meta"), "local")


def test_flash_check_rule_bites():
    """parity.flash_check, the rule chip_smoke.py and the card tests hold
    the kernel to, passes the plain version against itself and fails an
    output off by its tolerance or a kernel whose causal mask drops the
    diagonal (``k_pos < q_pos``)."""
    from repro_torch.kernels import parity

    q, k, v = (torch.from_numpy(x) for x in mk(n=2, s=128, hd=64, seed=3))
    o, lse = TF.flash_attention_plain(q, k, v)
    assert parity.flash_check(o, lse, o, lse).ok
    assert parity.flash_check(o.to(torch.bfloat16), lse, o, lse).ok
    off = o.clone()
    off[1, 7, 5] += 1e-5 + 2e-4 * abs(float(off[1, 7, 5]))
    assert parity.flash_check(off, lse, o, lse).o_bad == 1
    assert parity.flash_check(o, lse + 1e-3, o, lse).lse_bad == 128 * 2
    ulp = parity.bf16_ulp(o)
    assert parity.flash_check((o + 2 * ulp).to(torch.bfloat16), lse, o, lse).o_bad > 0
    scores = torch.einsum("nqd,nkd->nqk", q, k) / 8.0
    strict = torch.ones(128, 128, dtype=torch.bool).tril(-1)
    w = torch.softmax(scores.masked_fill(~strict, TF.NEG), -1)
    mutant = torch.einsum("nqk,nkd->nqd", w, v)
    assert not parity.flash_check(mutant, lse, o, lse).ok
