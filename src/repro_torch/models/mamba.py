"""Selective SSM (Mamba-2 / SSD form) for the Hymba hybrid heads — port
of ``repro.models.mamba``.

Chunked "state-space dual" algorithm: scalar per-head decay a_t, input
projection B_t, readout C_t, state size N (= cfg.ssm_state):

    h_t = exp(a_t) · h_{t-1} + B_t ⊗ x_t         (h: (H, N, P))
    y_t = C_t · h_t

Training and prefill use the chunk-parallel form (an intra-chunk masked
quadratic and an inter-chunk state scan, here a loop over the chunks), so
the state is materialized at chunk boundaries only.  Decoding is the O(1)
recurrence.  As in the reference, Hymba's Mamba-1 (a diagonal A per
channel) is simplified to Mamba-2's scalar A per head.

One deliberate difference: the intra-chunk decay is masked *before* its
exp.  The reference forms ``where(causal, exp(decay), 0)``; above the
diagonal ``decay`` is positive, and at Hymba's width a chunk's summed step
sizes pass f32's exp limit (88.7), so ``exp`` gives inf there.  The
forward drops those entries, but the backward multiplies their zero
cotangent by inf and every gradient becomes NaN (ROADMAP Queue 3 item 13).
``exp(decay.masked_fill(~causal, -inf))`` gives the same forward bit for
bit and a finite gradient.

The ``nn.Linear`` layout holds: each weight is stored (out, in), where the
reference stores (in, out).  No hand-written kernel stands behind this
module: the reference computes it outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig

CHUNK = 128


def mamba_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(num_heads, head_dim) of the SSM branch — mirrors attention heads."""
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.num_heads
    return h, d_inner // h


class Mamba(nn.Module):
    """``mamba_init``: w_x, w_z (d → H·P), w_B, w_C (d → H·N), w_dt (d → H)
    and w_out (H·P → d) in the config's dtype, and A_log (H,) f32 zeros
    (a = −exp(A_log)·softplus(dt))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt, d = L.param_dtype(cfg), cfg.d_model
        h, pd = mamba_heads(cfg)
        n = cfg.ssm_state
        self.w_x = L._empty((h * pd, d), dt, device)
        self.w_z = L._empty((h * pd, d), dt, device)
        self.w_B = L._empty((h * n, d), dt, device)
        self.w_C = L._empty((h * n, d), dt, device)
        self.w_dt = L._empty((h, d), dt, device)
        self.A_log = nn.Parameter(torch.zeros((h,), dtype=torch.float32, device=device))
        self.w_out = L._empty((d, h * pd), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_x, self.w_z, self.w_B, self.w_C, self.w_dt, self.w_out):
            L.dense_init_(w, gen)


def _proj(cfg: ModelConfig, p: Mamba, x: torch.Tensor, shd: ShardingConfig = NO_SHARDING):
    """x (B, S, d) → xv, z (B, S, H, P), B, C (B, S, H, N) in x's dtype,
    the step size Δt and the log-decay a = −exp(A_log)·Δt (B, S, H) f32."""
    h, _ = mamba_heads(cfg)
    xv = L.split_heads(F.linear(x, p.w_x), h, shd)
    z = L.split_heads(F.linear(x, p.w_z), h, shd)
    bm = L.split_heads(F.linear(x, p.w_B), h, shd)
    cm = L.split_heads(F.linear(x, p.w_C), h, shd)
    dt_ = F.softplus(F.linear(x, p.w_dt).float())
    a = -torch.exp(p.A_log)[None, None] * dt_
    return xv, z, bm, cm, dt_, a


def mamba_scan(cfg: ModelConfig, p: Mamba, x: torch.Tensor, return_state: bool = False,
               shd: ShardingConfig = NO_SHARDING):
    """Training/prefill path — chunked SSD.  x: (B, S, d) → (B, S, d), and
    with ``return_state`` the final state (B, H, N, P) f32 too.  The chunk
    is min(CHUNK, S), which must divide S (so a sequence past 128 tokens is
    a multiple of 128), as the reference asserts."""
    p = L.Gathered(p, shd) if shd.enabled else p
    s = x.shape[1]
    h, _ = mamba_heads(cfg)
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"mamba_scan: a sequence of {s} tokens is not a multiple of its "
                         f"chunk {q} (sequences past {CHUNK} tokens must be multiples of "
                         f"{CHUNK})")

    xv, z, bm, cm, dt_, a = _proj(cfg, p, x, shd)
    xv = xv * dt_[..., None]                               # fold Δt into the input
    inputs = (xv.float(), bm.float(), cm.float(), a)
    ssd = functools.partial(_ssd, q=q)
    y, carry = (L.scan_on_pieces(shd, h, ssd, inputs, (), 1) if L.is_dtensor(x)
                else ssd(*inputs))
    y = y * F.silu(z.float())
    y = L.shard(y, shd, L.dp(shd), None, shd.tp, None)
    out = F.linear(L.merge_heads(y.to(x.dtype), shd), p.w_out)
    if return_state:
        return out, carry
    return out


def _ssd(xv: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, a: torch.Tensor, q: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD of (B, S, H, ·) inputs (xv with Δt folded in, B, C
    in f32; the log-decay a (B, S, H)) in chunks of q → y (B, S, H, P) f32
    and the final state (B, H, N, P) f32.  Every (batch, head) is
    independent of the others."""
    b, s, h, pd = xv.shape
    n, nc = bm.shape[-1], s // q

    def ch(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    xv, bm, cm, a = ch(xv), ch(bm), ch(cm), ch(a)
    acs = torch.cumsum(a, dim=2)                           # (B, NC, Q, H) within a chunk
    # -- intra-chunk: the masked quadratic in Q, masked before the exp --
    decay = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # (B, NC, Qq, Qk, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=xv.device).tril()[None, None, :, :, None]
    gm = torch.exp(decay.masked_fill(~causal, -math.inf))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cm, bm) * gm
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xv)

    # -- each chunk's state, then the inter-chunk scan --
    tail = acs[:, :, -1:, :] - acs                         # decay to the chunk's end
    st = torch.einsum("bcqhn,bcqhp,bcqh->bchnp", bm, xv, torch.exp(tail))
    chunk_decay = torch.exp(acs[:, :, -1, :])              # (B, NC, H)
    carry = torch.zeros((b, h, n, pd), dtype=torch.float32, device=xv.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                                 # the state BEFORE chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + st[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B, NC, H, N, P)

    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", cm, prev_states, torch.exp(acs))
    return (y_intra + y_inter).reshape(b, s, h, pd), carry


def mamba_prefill_state(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                        shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """Final (B, H, N, P) state after processing x (prefill priming)."""
    return mamba_scan(cfg, p, x, return_state=True, shd=shd)[1]


def mamba_decode_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    h, pd = mamba_heads(cfg)
    return torch.zeros((batch, h, cfg.ssm_state, pd), dtype=dtype, device=device)


def mamba_decode_step(cfg: ModelConfig, p: Mamba, x: torch.Tensor, state: torch.Tensor,
                      shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, 1, d), state (B, H, N, P) → (out (B, 1, d), the new state)."""
    p = L.Gathered(p, shd) if shd.enabled else p
    b = x.shape[0]
    h, pd = mamba_heads(cfg)
    xv, z, bm, cm, dt_, a = _proj(cfg, p, x, shd)
    xv = (xv * dt_[..., None]).float()[:, 0]               # (B, H, P)
    bm, cm, a = bm.float()[:, 0], cm.float()[:, 0], a[:, 0]
    new_state = (state * torch.exp(a)[:, :, None, None]
                 + torch.einsum("bhn,bhp->bhnp", bm, xv))
    y = torch.einsum("bhn,bhnp->bhp", cm, new_state)
    y = y * F.silu(z.float()[:, 0])
    out = F.linear(L.merge_heads(y.reshape(b, 1, h, pd).to(x.dtype), shd), p.w_out)
    return out, new_state
