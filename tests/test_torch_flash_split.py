"""The numeric design of the tensor-core backward pair that f32 and hd 16
take (``csrc/flash_attention_dq.cu``, ``csrc/flash_attention_dkv.cu``):
3xTF32 products on the CPU, against the plain backward in f32.

The CUDA kernels run only on the card (tests/test_torch_kernels_cuda.py
holds them to the plain version there).  Here ``emulate_bwd`` repeats their
f32 arithmetic in PyTorch: every operand x of a product is split into
big = tf32(x) and small = tf32(x - big), TF32 rounding to nearest done on
the f32 bits with integer operations as the kernels do it (``tf32``), and a
product is small·big' + big·small' + big·big' with f32 sums; scores in log2
units, p = exp2(s·scale·log₂e − LSE·log₂e), 0 where masked; ds = p·(dP −
delta); dQ over tiles of 32 keys, dK and dV over tiles of 64 queries (32 at
hd 96 and 128), in the kernels' loop order, p and ds split like any other
operand before the products that contract over queries or keys.  Each
gradient must stay within a tenth of the f32 rule the kernels meet on the
card (``parity.flash_bwd_check``: atol 2e-5 + rtol 1e-3) of
``flash_attention_bwd_plain``.  One TF32 product alone (big·big') breaks
the rule: its ~3 decimal digits are too close to rtol 1e-3.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import parity

KEYS = 32               # keys a dQ tile, as the kernel's
LOG2E = np.float32(math.log2(math.e))
CASES = [(4, 256, 64, *m) for m in (("full", 0, True, True), ("full", 0, False, True),
                                    ("sliding", 64, True, False), ("sliding", 64, True, True),
                                    ("chunked", 64, True, False))] + [
    (8, 128, 16, "full", 0, True, True),
    (3, 200, 128, "full", 0, True, True), (3, 200, 96, "sliding", 50, True, False),
    (2, 200, 64, "chunked", 48, False, False)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (10 mantissa bits), rounded to nearest with ties away
    from zero: add half of the last kept bit to the bits, clear the 13
    dropped ones."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product(a: torch.Tensor, b: torch.Tensor, three: bool = True) -> torch.Tensor:
    """a @ b as the kernels' tensor cores take it: 3xTF32 (or big·big' alone)."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    if not three:
        return ab @ bb
    return asm @ bb + ab @ bsm + ab @ bb


def _p_ds(q, k, v, do, lse2, delta, q0, k0, mask, three):
    hd = q.shape[-1]
    scale_log2 = LOG2E / np.float32(math.sqrt(hd))
    allowed = TF.attention_mask(torch.arange(q0, q0 + q.shape[1]),
                                torch.arange(k0, k0 + k.shape[1]), *mask)
    p = torch.exp2(product(q, k.transpose(1, 2), three) * scale_log2 - lse2[..., None])
    p = torch.where(allowed[None], p, torch.zeros_like(p))
    return p, p * (product(do, v.transpose(1, 2), three) - delta[..., None])


def emulate_bwd(q, k, v, do, lse, delta, attention, window, causal, is_global, three=True):
    """The kernels' f32 arithmetic → (dQ, dK, dV) f32."""
    n, s, hd = q.shape
    scale = np.float32(1.0 / math.sqrt(hd))
    queries = 32 if hd >= 96 else 64                # queries a dK/dV tile, as the kernel's
    mask = (attention, window, causal, is_global)
    lse2 = lse * LOG2E
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[1], KEYS):           # the dQ kernel: key tiles
        kt, vt = k[:, k0:k0 + KEYS], v[:, k0:k0 + KEYS]
        _, ds = _p_ds(q, kt, vt, do, lse2, delta, 0, k0, mask, three)
        dq += product(ds, kt, three)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, s, queries):                 # the dK/dV kernel: query tiles
        sl = slice(q0, q0 + queries)
        p, ds = _p_ds(q[:, sl], k, v, do[:, sl], lse2[:, sl], delta[:, sl], q0, 0, mask, three)
        dv += product(p.transpose(1, 2), do[:, sl], three)
        dk += product(ds.transpose(1, 2), q[:, sl], three)
    return dq * scale, dk * scale, dv


def worst_share(n, s, hd, attn, win, causal, glob, seed, three=True) -> dict:
    """Each gradient's largest err / (atol + rtol·|ref|) against the plain
    backward in f32, on seeded ~N(0, 0.3²) inputs."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy((rng.normal(size=(n, s, hd)) * 0.3).astype(np.float32))
                   for _ in range(4))
    mask = (attn, win, causal, glob)
    o, lse = TF.flash_attention_plain(q, k, v, *mask)
    ref = TF.flash_attention_bwd_plain(q, k, v, o, lse, do, *mask)
    got = emulate_bwd(q, k, v, do, lse, TF.flash_delta(o, do), *mask, three=three)
    assert parity.GRAD_ATOL == 2e-5 and parity.GRAD_RTOL == 1e-3
    return {name: float(((g - r).abs() / (parity.GRAD_ATOL + parity.GRAD_RTOL * r.abs())).max())
            for name, g, r in zip(("dq", "dk", "dv"), got, ref)}


def test_tf32_rounds_to_nearest():
    """tf32(x) keeps 10 mantissa bits (the low 13 are zero), lies within
    half a TF32 ulp (2⁻¹¹·|x|) of x, and rounds ties away from zero."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=100_000) * 10.0 ** rng.integers(-30, 30, size=100_000),
        rng.uniform(-1, 1, size=10_000)]).astype(np.float32))
    t = tf32(x)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - t).abs() <= 2.0 ** -11 * x.abs()).all())
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11], dtype=torch.float32)
    torch.testing.assert_close(tf32(ties), torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                                         1 + 2 * 2.0 ** -10]), rtol=0, atol=0)
    big, small = split(x)
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x.double() - big.double() - small.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("n,s,hd,attn,win,causal,glob", CASES)
def test_3xtf32_within_a_tenth_of_the_f32_rule(n, s, hd, attn, win, causal, glob):
    shares = worst_share(n, s, hd, attn, win, causal, glob, seed=n * s + hd)
    assert max(shares.values()) <= 0.1, shares


@pytest.mark.parametrize("n,s,hd", [(4, 256, 64), (8, 128, 16)])
def test_one_tf32_product_breaks_the_rule(n, s, hd):
    """big·big' alone puts each gradient past the f32 rule somewhere, where
    3xTF32 stays under a tenth of it."""
    shares = worst_share(n, s, hd, "full", 0, True, True, seed=n * s + hd, three=False)
    assert min(shares.values()) > 1.0, shares
