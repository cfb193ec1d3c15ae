"""Shared neural layers — port of ``repro.models.layers``: norms, RoPE,
GQA attention (full / sliding / chunked masks; naive, chunked-query and
flash implementations), the GLU MLP and the embeddings.

Parameters live in ``nn.Module``s built on the target device and filled
from an explicit ``torch.Generator`` with the reference's distributions.
A dense weight is stored (out, in), ``nn.Linear``'s layout, where the
reference stores (in, out); ``interop.backbone_params_from_numpy``
transposes.  The reference's sharding arguments are dropped: one card
has no mesh.  Cross-attention passes the encoder's K/V as
``kv_override``: only q is projected, and the path is naive (or
chunked-query), as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_mask
from repro_torch.models.config import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NEG = -1e30


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def dense_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """``dense_init``: N(0, 1/d_in) for a weight stored (out, in).  The f32
    draw is scaled in place, so one f32 temporary of the weight is alive
    (7.8 GiB for Command-R's 256,000 × 8,192 output projection)."""
    z = torch.randn(w.shape, generator=gen, device=w.device, dtype=torch.float32)
    w.copy_(z.mul_(1.0 / math.sqrt(w.shape[1])))


# -- norms ----------------------------------------------------------------------


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros((d,), dtype=torch.float32, device=device))
                     if cfg.norm == "layernorm" else None)


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * p.scale + p.bias
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p.scale
    return out.to(x.dtype)


# -- rotary position embedding ---------------------------------------------------


def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    hd = cfg.hd
    return 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                  device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer.  Angles in f32."""
    ang = positions[..., :, None].float()[..., None, :] * freqs   # (..., S, 1, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention --------------------------------------------------------------------


class Attention(nn.Module):
    """``attn_init``: wq, wk, wv, wo (and bq, bk, bv with ``qkv_bias``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = param_dtype(cfg)
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        self.wq = _empty((h * hd, d), dt, device)
        self.wk = _empty((kv * hd, d), dt, device)
        self.wv = _empty((kv * hd, d), dt, device)
        self.wo = _empty((d, h * hd), dt, device)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros((h * hd,), dtype=dt, device=device))
            self.bk = nn.Parameter(torch.zeros((kv * hd,), dtype=dt, device=device))
            self.bv = nn.Parameter(torch.zeros((kv * hd,), dtype=dt, device=device))
        else:
            self.bq = self.bk = self.bv = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)


def _attn_mask(cfg: ModelConfig, q_pos: torch.Tensor, k_pos: torch.Tensor,
               is_global: bool, causal: bool = True) -> torch.Tensor:
    """(Sq, Sk) boolean mask — full / sliding-window / chunked-local (the
    flash kernel's mask, so every attention path masks alike)."""
    return attention_mask(q_pos, k_pos, cfg.attention, cfg.window, causal, is_global)


def qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor,
        freqs: torch.Tensor, causal: bool = True, use_rope: bool = True,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projected q (B, S, H, hd) and k, v (B, S, KV, hd), RoPE applied to
    q and k of causal self-attention with ``use_rope``.  With
    ``kv_override`` (cross-attention) only q is projected and k, v are
    the override's, unrotated."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = F.linear(x, p.wq, p.bq).reshape(b, s, h, hd)
    rope = causal and use_rope     # RoPE on self-attention only (Whisper: none)
    if kv_override is None:
        k = F.linear(x, p.wk, p.bk).reshape(b, s, kv, hd)
        v = F.linear(x, p.wv, p.bv).reshape(b, s, kv, hd)
        if rope:
            k = apply_rope(k, positions, freqs)
    else:
        k, v = kv_override
    if rope:
        q = apply_rope(q, positions, freqs)
    return q, k, v


def mha_kv(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor,
           freqs: torch.Tensor, is_global: bool, causal: bool = True,
           use_rope: bool = True,
           kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mha`` that also returns this layer's k and v (post-RoPE), which
    prefill writes into the cache."""
    b, s, _ = x.shape
    q, k, v = qkv(cfg, p, x, positions, freqs, causal, use_rope, kv_override)
    if kv_override is None:
        k_pos = positions[0]
    else:
        k_pos = torch.arange(k.shape[1], device=x.device)
    if (cfg.attn_impl == "flash" and kv_override is None
            and s == k.shape[1] and s % 128 == 0):
        out = _attn_flash(cfg, q, k, v, is_global, causal)
    elif cfg.attn_impl == "chunked_q":
        out = _attn_chunked_q(cfg, q, k, v, positions, k_pos, is_global, causal)
    else:
        out = _attn_naive(cfg, q, k, v, positions, k_pos, is_global, causal)
    out = out.reshape(b, s, cfg.num_heads * cfg.hd)
    return F.linear(out, p.wo), k, v


def mha(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor,
        freqs: torch.Tensor, is_global: bool, causal: bool = True,
        use_rope: bool = True,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """x: (B, S, d); positions: (B, S); ``kv_override`` (k, v), each (B,
    Sk, KV, hd), attends to them at key positions 0..Sk-1.  Flash is
    taken when ``attn_impl == "flash"``, there is no override and S is a
    multiple of 128, as in the reference; otherwise the naive path."""
    return mha_kv(cfg, p, x, positions, freqs, is_global, causal, use_rope, kv_override)[0]


def _attn_naive(cfg, q, k, v, positions, k_pos, is_global, causal):
    """Paper-faithful baseline: full (…,S,S) score materialization."""
    b, s, h, hd = q.shape
    qg = q.reshape(b, s, k.shape[2], -1, hd)          # grouped-query folding
    scores = torch.einsum("bsgqh,btgh->bgqst", qg, k).float() / math.sqrt(hd)
    mask = _attn_mask(cfg, positions[0], k_pos, is_global, causal)
    scores = scores.masked_fill(~mask, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgqst,btgh->bsgqh", w, v)


def _expand_kv(k: torch.Tensor, v: torch.Tensor, h: int):
    """GQA → full heads (each KV head repeated for its query group)."""
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    return k, v


def _attn_flash(cfg, q, k, v, is_global, causal):
    """The flash-attention kernels on (B·H, S, hd): KV heads expanded to
    full heads and folded with the batch (no head padding: one card).
    Differentiable: the backward of the ``repeat_interleave`` sums dK and
    dV over each query group, as ``jnp.repeat``'s does."""
    b, s, h, hd = q.shape
    k, v = _expand_kv(k, v, h)
    window = cfg.window if cfg.attention in ("sliding", "chunked") else 0
    fold = lambda x: x.transpose(1, 2).reshape(b * h, s, hd).contiguous()   # noqa: E731
    o = ops.flash_attention_nhsd(fold(q), fold(k), fold(v), cfg.attention,
                                 window, causal, bool(is_global))
    return o.reshape(b, h, s, hd).transpose(1, 2)


def _attn_chunked_q(cfg, q, k, v, positions, k_pos, is_global, causal):
    """Query chunks of ``attn_q_chunk`` rows, each an exact row softmax:
    scores residency (b, h, Qc, S) per chunk instead of (b, h, S, S)."""
    b, s, h, hd = q.shape
    k, v = _expand_kv(k, v, h)
    qc = min(cfg.attn_q_chunk, s)
    nc = s // qc if s % qc == 0 else 1
    qc = s // nc
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for c in range(nc):
        qb = q[:, c * qc:(c + 1) * qc]
        sc = torch.einsum("bqhd,bthd->bhqt", qb, k).float() * scale
        mask = _attn_mask(cfg, positions[0, c * qc:(c + 1) * qc], k_pos, is_global, causal)
        sc = sc.masked_fill(~mask, NEG)
        w = torch.softmax(sc, dim=-1).to(qb.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", w, v))
    return torch.cat(outs, dim=1)


# -- GLU MLP -----------------------------------------------------------------------


class GLU(nn.Module):
    """``mlp_init``: w_gate, w_up (d → f) and w_down (f → d)."""

    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None, device=None):
        super().__init__()
        dt, d, f = param_dtype(cfg), cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = _empty((f, d), dt, device)
        self.w_up = _empty((f, d), dt, device)
        self.w_down = _empty((d, f), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, gen)


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(cfg.act)


def mlp(cfg: ModelConfig, p: GLU, x: torch.Tensor) -> torch.Tensor:
    return F.linear(_act(cfg, F.linear(x, p.w_gate)) * F.linear(x, p.w_up), p.w_down)


# -- embeddings ----------------------------------------------------------------------


class Embed(nn.Module):
    """``embed_init``: ``tok`` (V, d) ~ N(0, 0.02²) and, unless the
    embeddings are tied, the output projection ``out`` stored (V, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = param_dtype(cfg)
        self.tok = _empty((cfg.vocab_size, cfg.d_model), dt, device)
        self.out = (None if cfg.tie_embeddings
                    else _empty((cfg.vocab_size, cfg.d_model), dt, device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        z = torch.randn(self.tok.shape, generator=gen, device=self.tok.device,
                        dtype=torch.float32)
        self.tok.copy_(z.mul_(0.02))
        if self.out is not None:
            dense_init_(self.out, gen)


def embed(cfg: ModelConfig, p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens]


def unembed(cfg: ModelConfig, p: Embed, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.tok if cfg.tie_embeddings else p.out)
