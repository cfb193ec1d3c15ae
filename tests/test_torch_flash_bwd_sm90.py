"""The arithmetic of the Hopper flash-attention backward pair
(``csrc/flash_attention_dq_sm90.cu`` and ``csrc/flash_attention_dkv_sm90.cu``)
against the Pallas backward (repro.kernels.flash_attention, interpret mode
on the CPU), and the choice of backward kernels.

The CUDA kernels run only on the card (tests/test_torch_kernels_cuda.py
holds them to the plain version there).  Here ``emulate_bwd`` repeats their
arithmetic in PyTorch on the CPU: bf16 q, k, v and dO; score products
summed in f32; scores in log2 units, p = exp2(s·scale·log₂e − LSE·log₂e),
0 where masked; ds = p·(dP − delta); dQ over tiles of 64 keys and dK, dV
over tiles of 64 queries, in the kernels' loop order; p and ds split into
hi = bf16(x) and lo = bf16(x − hi), two products each into f32
accumulators; the results cast to bf16.  It is held to ``jax.grad`` of
``flash_attention_nhsd`` (the Pallas ``_bwd``, bq = bk = 64, or 40 at the
ragged S = 200) on bf16-representable inputs, with the reference's own O
and LSE, under ``parity.flash_bwd_check``, the rule the kernels meet on the
card: each gradient within one bf16 ulp beyond atol 2e-5.  The same
emulation with p and ds rounded to bf16 alone breaks that rule, which is
why the kernels split them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import parity

torch.set_num_threads(2)

KEYS = 64               # keys a dQ tile, as the kernel's
QUERIES = 64            # queries a dK/dV tile, as the kernel's
LOG2E = np.float32(math.log2(math.e))
CASES = [
    ("full", 0, True, True),
    ("full", 0, False, True),
    ("sliding", 64, True, False),
    ("sliding", 64, True, True),
    ("chunked", 64, True, False),
]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a·b with a split into bf16 hi and lo (two products), or a in bf16
    alone; b holds bf16 values, the sums are f32."""
    hi = _bf16(a)
    return hi @ b + _bf16(a - hi) @ b if split else hi @ b


def _p_ds(q, k, v, do, lse2, delta, q0, k0, attention, window, causal, is_global):
    """p and ds of queries [q0, q0 + len(q)) against keys [k0, k0 + len(k))."""
    hd = q.shape[-1]
    scale_log2 = LOG2E / np.float32(math.sqrt(hd))
    mask = TF.attention_mask(torch.arange(q0, q0 + q.shape[1]), torch.arange(k0, k0 + k.shape[1]),
                             attention, window, causal, is_global)
    p = torch.exp2((q @ k.transpose(1, 2)) * scale_log2 - lse2[..., None])
    p = torch.where(mask[None], p, torch.zeros_like(p))
    return p, p * (do @ v.transpose(1, 2) - delta[..., None])


def emulate_bwd(q, k, v, do, lse, delta, attention, window, causal, is_global, split=True):
    """The kernels' arithmetic on f32 tensors holding bf16 values → (dQ, dK, dV) bf16."""
    n, s, hd = q.shape
    scale = np.float32(1.0 / math.sqrt(hd))
    mask = (attention, window, causal, is_global)
    lse2 = lse * LOG2E
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[1], KEYS):           # the dQ kernel: key tiles
        kt, vt = k[:, k0:k0 + KEYS], v[:, k0:k0 + KEYS]
        _, ds = _p_ds(q, kt, vt, do, lse2, delta, 0, k0, *mask)
        dq += _dot(ds, kt, split)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, s, QUERIES):                 # the dK/dV kernel: query tiles
        sl = slice(q0, q0 + QUERIES)
        p, ds = _p_ds(q[:, sl], k, v, do[:, sl], lse2[:, sl], delta[:, sl], q0, 0, *mask)
        dv += _dot(p.transpose(1, 2), do[:, sl], split)
        dk += _dot(ds.transpose(1, 2), q[:, sl], split)
    return tuple(x.to(torch.bfloat16) for x in (dq * scale, dk * scale, dv))


def mk(n, s, hd, seed):
    """q, k, v, dO as f32 arrays of bf16 values, ~N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(n, s, hd)) * 0.3).astype(np.float32))
            .to(torch.bfloat16).float().numpy() for _ in range(4)]


def pallas(q, k, v, do, attn, win, causal, glob, block):
    """jax.grad of Σ flash(q, k, v)·dO (the Pallas _bwd with upstream
    gradient dO) → (dQ, dK, dV), and the forward's O and LSE."""
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))

    def loss(q, k, v):
        return jnp.sum(FA.flash_attention_nhsd(q, k, v, attn, win, causal, glob, bq=block,
                                               bk=block, interpret=True) * jdo)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = FA._fwd(jq, jk, jv, jnp.asarray([int(glob)], jnp.int32), attn, win, causal,
                     block, block, True)
    return [torch.from_numpy(np.array(x)) for x in (*grads, o, lse)]


def _check(n, s, hd, attn, win, causal, glob, block, seed, split=True):
    q, k, v, do = mk(n, s, hd, seed)
    dq_ref, dk_ref, dv_ref, o, lse = pallas(q, k, v, do, attn, win, causal, glob, block)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    got = emulate_bwd(tq, tk, tv, tdo, lse, TF.flash_delta(o, tdo), attn, win, causal, glob,
                      split=split)
    assert all(g.dtype == torch.bfloat16 for g in got)
    return parity.flash_bwd_check(*got, dq_ref, dk_ref, dv_ref)


@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("attn,win,causal,glob", CASES)
def test_emulation_matches_pallas(attn, win, causal, glob, hd):
    report = _check(2, 256, hd, attn, win, causal, glob, 64, seed=hd)
    assert report.ok, report


@pytest.mark.parametrize("hd,attn,win,causal,glob", [(128, "full", 0, True, True),
                                                     (96, "sliding", 50, True, False),
                                                     (64, "chunked", 48, False, False)])
def test_emulation_matches_pallas_ragged(hd, attn, win, causal, glob):
    """S = 200: the kernels' last tile runs past S (dQ's keys, dK/dV's queries)."""
    report = _check(2, 200, hd, attn, win, causal, glob, 40, seed=200 + hd)
    assert report.ok, report


def test_bf16_p_and_ds_alone_break_the_rule():
    """p and ds rounded to bf16 before their products (FlashAttention-2/3's
    choice) put many gradients of a causal (4, 512, 128) call more than one
    bf16 ulp from the f32 result; the hi/lo split leaves none."""
    args = (4, 512, 128, "full", 0, True, True, 128)
    split = _check(*args, seed=5)
    single = _check(*args, seed=5, split=False)
    assert split.ok, split
    assert min(single.bad.values()) > 0 and sum(single.bad.values()) > 10_000, single
    assert single.max_ulps > 100, single


@pytest.mark.parametrize("hd", TF.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_for(dtype, hd):
    """bf16 at hd 64/96/128 → the Hopper pair; f32, and hd 16 → the mma.sync pair."""
    want = ((TF.DQ_SM90_NAME, TF.DKV_SM90_NAME) if dtype == torch.bfloat16 and hd in (64, 96, 128)
            else (TF.DQ_NAME, TF.DKV_NAME))
    assert TF._bwd_kernel_for(dtype, hd) == want


@pytest.mark.parametrize("fn", [TF.flash_attention_dq_sm90_cuda, TF.flash_attention_dkv_sm90_cuda])
def test_sm90_bwd_wrappers_refuse_cpu_tensors(fn):
    """The Hopper backward's wrappers have no plain fallback: CPU tensors raise."""
    q = torch.zeros((2, 128, 128), dtype=torch.bfloat16)
    rows = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="CUDA device"):
        fn(q, q, q, q, rows, rows)
