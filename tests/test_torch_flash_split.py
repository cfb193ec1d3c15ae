"""The numeric design of the tensor-core kernels that f32 and hd 16 take,
the backward pair (``csrc/flash_attention_dq.cu``,
``csrc/flash_attention_dkv.cu``) and the forward
(``csrc/flash_attention_fwd.cu``, ``emulate_fwd`` below): 3xTF32 products
on the CPU, against the plain backward and forward in f32.

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


# -- the forward (csrc/flash_attention_fwd.cu) ---------------------------------

LN2 = np.float32(math.log(2.0))
NEG2 = np.float32(TF.NEG * float(LOG2E))    # a masked score, in log2 units
FWD_CASES = [(*c[:3], None, *c[3:], "float32") for c in CASES] + [
    (32, 128, 16, None, "full", 0, True, True, "bfloat16"),
    (2, 256, 16, 100, "full", 0, False, True, "float32"),
    (2, 100, 64, 300, "full", 0, True, True, "float32")]


def _pv(p: torch.Tensor, v: torch.Tensor, bf16: bool, three: bool) -> torch.Tensor:
    """p @ v as the kernel's P·V: 3xTF32 in f32; in bf16 (v exact) P split
    in three, hi = bf16(p), mid = bf16(p − hi), lo = bf16(p − hi − mid),
    lo's product first (hi + lo alone leaves P ~2⁻¹⁷ off and puts O at
    0.16 of the rule)."""
    if not bf16:
        return product(p, v, three)
    hi = p.bfloat16().float()
    mid = (p - hi).bfloat16().float()
    return (p - hi - mid).bfloat16().float() @ v + mid @ v + hi @ v


def emulate_fwd(q, k, v, attention, window, causal, is_global, deep, three=True):
    """The kernel's arithmetic → (O f32 before the cast, LSE).  Scores in
    log2 units (scale·log₂e folded in), the online softmax over its key
    tiles in its loop order: WIDE walks 16-key tiles; DEEP gives each of
    four parts its 8 (bf16: 16) keys of every tile, each with its own (m,
    l, O), merged into the first in order.  Masked entries score NEG·log₂e;
    keys past Sk add nothing.  Skipping the tiles no query of a CTA can
    reach changes no bit here: every row of these cases sees a key."""
    n, s, hd = q.shape
    sk = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    kw = (16 if bf16 else 8) if deep else 16
    parts = 4 if deep else 1
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(np.float32(hd))) * LOG2E)
    qf, kf, vf = q.float(), k.float(), v.float()
    states = [[torch.full((n, s, 1), float(NEG2)), torch.zeros((n, s, 1)),
               torch.zeros((n, s, hd))] for _ in range(parts)]
    for k0 in range(0, sk, kw * parts):
        for part, st in enumerate(states):
            a, b = k0 + part * kw, min(k0 + (part + 1) * kw, sk)
            if a >= sk:
                continue
            kt = kf[:, a:b]
            sc = qf @ kt.transpose(1, 2) if bf16 else product(qf, kt.transpose(1, 2), three)
            x = sc * scale_log2
            allowed = TF.attention_mask(torch.arange(s), torch.arange(a, b), attention, window,
                                        causal, is_global)
            x = torch.where(allowed[None], x, torch.full_like(x, float(NEG2)))
            m, l, acc = st
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            corr, p = torch.exp2(m - m_new), torch.exp2(x - m_new)
            st[:] = [m_new, l * corr + p.sum(-1, keepdim=True),
                     acc * corr + _pv(p, vf[:, a:b], bf16, three)]
    m, l, acc = states[0]
    for mo, lo, acco in states[1:]:
        m_new = torch.maximum(m, mo)
        c0, co = torch.exp2(m - m_new), torch.exp2(mo - m_new)
        m, l, acc = m_new, l * c0 + lo * co, acc * c0 + acco * co
    l = l.clamp_min(1e-30)
    return acc / l, (m * LN2 + torch.log(l))[..., 0]


def fwd_share(n, s, hd, sk, attn, win, causal, glob, dtype, deep, seed, three=True) -> dict:
    """O's and the LSE's largest err / rule against the plain forward in
    f32, on seeded ~N(0, 0.3²) inputs: f32's rule atol 2e-6 + rtol 1e-4;
    O from bf16 inputs held, before its cast, to bf16's atol 2e-6 + one
    bf16 ulp; the LSE's atol 1e-6 + rtol 1e-5."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((rng.normal(size=(n, r, hd)) * 0.3).astype(np.float32))
               .to(getattr(torch, dtype)) for r in (s, sk or s, sk or s))
    mask = (attn, win, causal, glob)
    o_ref, lse_ref = TF.flash_attention_plain(q.float(), k.float(), v.float(), *mask)
    o, lse = emulate_fwd(q, k, v, *mask, deep=deep, three=three)
    assert parity.FLASH_ATOL == 2e-6 and parity.FLASH_RTOL == 1e-4
    assert parity.LSE_ATOL == 1e-6 and parity.LSE_RTOL == 1e-5
    o_rule = parity.FLASH_ATOL + (parity.bf16_ulp(o_ref) if dtype == "bfloat16"
                                  else parity.FLASH_RTOL * o_ref.abs())
    return {"o": float(((o - o_ref).abs() / o_rule).max()),
            "lse": float(((lse - lse_ref).abs()
                          / (parity.LSE_ATOL + parity.LSE_RTOL * lse_ref.abs())).max())}


@pytest.mark.parametrize("deep", [False, True], ids=["wide", "deep"])
@pytest.mark.parametrize("n,s,hd,sk,attn,win,causal,glob,dtype", FWD_CASES)
def test_fwd_within_a_tenth_of_the_rule(n, s, hd, sk, attn, win, causal, glob, dtype, deep):
    shares = fwd_share(n, s, hd, sk, attn, win, causal, glob, dtype, deep, seed=n * s + hd)
    assert max(shares.values()) <= 0.1, shares


@pytest.mark.parametrize("deep", [False, True], ids=["wide", "deep"])
def test_fwd_one_tf32_product_breaks_the_rule(deep):
    """big·big' alone puts O past the f32 forward rule, where 3xTF32 stays
    under a tenth of it."""
    shares = fwd_share(4, 256, 64, None, "full", 0, True, True, "float32", deep, seed=4 * 256 + 64,
                       three=False)
    assert shares["o"] > 1.0, shares
