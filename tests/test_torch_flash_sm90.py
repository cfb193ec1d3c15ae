"""The arithmetic of the Hopper flash-attention forward
(``csrc/flash_attention_fwd_sm90.cu``) against the Pallas kernel
(repro.kernels.flash_attention, interpret mode on the CPU), and the choice
of forward kernel.

The CUDA kernel runs only on the card (tests/test_torch_kernels_cuda.py
holds it to the plain version there).  Here ``emulate`` repeats its
arithmetic in PyTorch on the CPU: bf16 inputs, Q·Kᵀ products summed in f32,
scores in log2 units, the online softmax over tiles of 64 keys (the
kernel's tile), P split into P_hi = bf16(P) and P_lo = bf16(P − P_hi), two
P·V products into one f32 accumulator, O cast to bf16.  It is held to the
Pallas forward (O through ``flash_attention_nhsd``, the LSE through
``_fwd``) on bf16-representable inputs under ``parity.flash_check``, the
rule the kernel meets on the card: O within one bf16 ulp beyond atol 2e-6,
the LSE at rtol 1e-5 + atol 1e-6.  The same emulation with P rounded to
bf16 alone breaks that rule, which is why the kernel splits P.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import parity

torch.set_num_threads(2)

BK = 64                 # keys a tile, as the kernel's
CASES = [
    ("full", 0, True, True),
    ("full", 0, False, True),
    ("sliding", 64, True, False),
    ("sliding", 64, True, True),
    ("chunked", 64, True, False),
]


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attention: str, window: int,
            causal: bool, is_global: bool, split: bool = True):
    """The kernel's arithmetic on f32 tensors holding bf16 values → (O bf16, LSE f32)."""
    n, s, hd = q.shape
    sk = k.shape[1]
    scale_log2 = np.float32(math.log2(math.e) / math.sqrt(hd))
    m = torch.full((n, s, 1), TF.NEG)
    l = torch.zeros((n, s, 1))
    acc = torch.zeros((n, s, hd))
    q_pos = torch.arange(s)
    for k_start in range(0, sk, BK):
        kt, vt = k[:, k_start:k_start + BK], v[:, k_start:k_start + BK]
        k_pos = torch.arange(k_start, k_start + kt.shape[1])
        x = (q @ kt.transpose(1, 2)) * scale_log2
        mask = TF.attention_mask(q_pos, k_pos, attention, window, causal, is_global)
        x = torch.where(mask[None], x, torch.full_like(x, TF.NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            acc = acc * corr + p_hi @ vt + p_lo @ vt
        else:
            acc = acc * corr + p_hi @ vt
        m = m_new
    lsum = l.clamp_min(1e-30)
    return (acc / lsum).to(torch.bfloat16), (m * math.log(2.0) + torch.log(lsum))[..., 0]


def mk(n, s, hd, seed):
    """q, k, v as f32 arrays of bf16 values, ~N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(n, s, hd)) * 0.3).astype(np.float32))
            .to(torch.bfloat16).float().numpy() for _ in range(3)]


def pallas(q, k, v, attn, win, causal, glob, block):
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o = FA.flash_attention_nhsd(jq, jk, jv, attn, win, causal, glob, bq=block, bk=block,
                                interpret=True)
    _, lse = FA._fwd(jq, jk, jv, jnp.asarray([int(glob)], jnp.int32), attn, win, causal,
                     block, block, True)
    return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))


@pytest.mark.parametrize("s,block", [(256, 64), (200, 40)])
@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("attn,win,causal,glob", CASES)
def test_emulation_matches_pallas(attn, win, causal, glob, hd, s, block):
    q, k, v = mk(2, s, hd, seed=s + hd)
    o_ref, lse_ref = pallas(q, k, v, attn, win, causal, glob, block)
    o, lse = emulate(*map(torch.from_numpy, (q, k, v)), attn, win, causal, glob)
    report = parity.flash_check(o, lse, o_ref, lse_ref)
    assert o.dtype == torch.bfloat16 and report.ok, report


def test_bf16_p_alone_breaks_the_rule():
    """P rounded to bf16 before P·V (FlashAttention-2/3's choice) puts many
    outputs of a causal (4, 512, 128) call more than one bf16 ulp from the
    f32 result; the hi/lo split leaves none."""
    q, k, v = mk(4, 512, 128, seed=5)
    o_ref, lse_ref = pallas(q, k, v, "full", 0, True, True, 128)
    args = (*map(torch.from_numpy, (q, k, v)), "full", 0, True, True)
    single = parity.flash_check(*emulate(*args, split=False), o_ref, lse_ref)
    split = parity.flash_check(*emulate(*args), o_ref, lse_ref)
    assert split.ok, split
    assert single.o_bad > 1000 and single.max_ulps > 1.0, single


@pytest.mark.parametrize("hd", TF.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_kernel_for(dtype, hd):
    """bf16 at hd 64/96/128 → the Hopper kernel; f32, and hd 16 → the f32-FMA one."""
    want = TF.SM90_NAME if dtype == torch.bfloat16 and hd in (64, 96, 128) else TF.NAME
    assert TF._fwd_kernel_for(dtype, hd) == want


def test_sm90_wrapper_refuses_cpu_tensors():
    """The Hopper kernel's wrapper has no plain fallback: CPU tensors raise."""
    q = torch.zeros((2, 128, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        TF.flash_attention_sm90_cuda(q, q, q)
