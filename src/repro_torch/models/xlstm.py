"""xLSTM blocks (arXiv:2405.04517) — port of ``repro.models.xlstm``: the
mLSTM (matrix memory, parallel heads) and the sLSTM (scalar memory with
recurrent mixing), attention-free.

The recurrent formulation with exponential input gates and
max-stabilizers, as the reference's.  Each of its ``lax.scan``s over the
sequence is a Python loop over time here; decoding is the O(1) state
update.  ``mlstm_forward_chunked`` (``cfg.mlstm_chunked``) is the
chunkwise-parallel training path, a loop over chunks of ``MLSTM_CHUNK``.
The reference's simplifications are kept: no depthwise conv4 branch, no
block-diagonal projections, gates are per-head scalars.

Weights are stored (out, in), ``nn.Linear``'s layout, where the reference
stores (in, out); the sLSTM's recurrent matrices (H, hd, hd) keep the
reference's layout.  ``mlstm_forward``/``slstm_forward`` take
``return_state`` and then also return the final state, so ``prefill``
runs each block once where the reference runs the forward and then the
``*_prefill_state`` scan again.  No hand-written kernel stands behind this
module: the reference computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig

NEG_INIT = -1e30      # the stabilizer's initial value
MLSTM_CHUNK = 64


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.num_heads, cfg.d_model // cfg.num_heads


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar for the binary ``torch.maximum``/``minimum``, whose
    gradient splits evenly at a tie, as ``jnp.maximum``'s does (the sLSTM's
    first step meets its floor n = 1 exactly); ``clamp`` would pass it all."""
    # repro-lint: disable=R404(a host scalar copied to the device at each recurrent step; ROADMAP held work B, the recurrent decode and collect)
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------- mLSTM ----


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, DK, DV) matrix memory
    n: torch.Tensor   # (B, H, DK) normalizer
    m: torch.Tensor   # (B, H) stabilizer


class MLSTM(nn.Module):
    """``mlstm_init``: wq, wk, wv, wo_gate (d → H·hd) and w_out (H·hd → d)
    in the config's dtype; the gate pre-activations wi, wf (d → H) in f32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt, d = L.param_dtype(cfg), cfg.d_model
        h, hd = _heads(cfg)
        self.wq = L._empty((h * hd, d), dt, device)
        self.wk = L._empty((h * hd, d), dt, device)
        self.wv = L._empty((h * hd, d), dt, device)
        self.wi = L._empty((h, d), torch.float32, device)
        self.wf = L._empty((h, d), torch.float32, device)
        self.wo_gate = L._empty((h * hd, d), dt, device)
        self.w_out = L._empty((d, h * hd), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wi, self.wf, self.wo_gate, self.w_out):
            L.dense_init_(w, gen)


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor each rank's piece through
    ``local_map`` (DTensor has no sharding rule for its backward)."""
    if not L.is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(x.placements)
    return local_map(F.logsigmoid, out_placements=list(pl), in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh)(x)


def _mlstm_qkvif(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                 shd: ShardingConfig = NO_SHARDING):
    """x (B, S, d) → q, k (scaled by 1/√hd), v (B, S, H, hd) in x's dtype,
    the log-space input gate and log forget gate (B, S, H) f32, and the
    output gate (B, S, H, hd) f32."""
    h, hd = _heads(cfg)
    q = L.split_heads(F.linear(x, p.wq), h, shd)
    k = L.split_heads(F.linear(x, p.wk), h, shd) / math.sqrt(hd)
    v = L.split_heads(F.linear(x, p.wv), h, shd)
    it = F.linear(x.float(), p.wi)
    logf = _logsigmoid(F.linear(x.float(), p.wf))
    og = torch.sigmoid(F.linear(x, p.wo_gate).float())
    return q, k, v, it, logf, L.split_heads(og, h, shd)


def mlstm_step(state: MLSTMState, q, k, v, it, logf):
    """One stabilized mLSTM step.  q/k/v: (B, H, hd); it/logf: (B, H).

    The denominator's floor is exp(−m) in the scaled space — 1.0 in the
    unscaled space, the paper's max(|qᵀn|, 1) (clipped against overflow).
    """
    m_new = torch.maximum(logf + state.m, it)
    f_ = torch.exp(logf + state.m - m_new)[..., None]
    i_ = torch.exp(it - m_new)[..., None]
    c = state.c * f_[..., None] + i_[..., None] * k[..., :, None] * v[..., None, :]
    n = state.n * f_ + i_ * k
    num = torch.einsum("bhk,bhkv->bhv", q, c)
    floor = torch.exp(torch.minimum(-m_new, _const(60.0, m_new)))
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)), floor)[..., None]
    return MLSTMState(c, n, m_new), num / den


def _full(shape, value, device, full):
    """An f32 state leaf: ``torch.full`` on ``device``, or ``full(shape,
    value, dtype)`` where the caller gives one (a cache on a mesh)."""
    if full is None:
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return full(shape, value, torch.float32)


def _beside(x: torch.Tensor):
    """The ``full`` of a scan's initial state beside ``x``: on a mesh each
    leaf replicated on x's mesh (the same on every rank), else None."""
    if not L.is_dtensor(x):
        return None
    return lambda shape, value, dtype: L.replicate_like(
        torch.full(shape, value, dtype=dtype, device=L.local(x).device), x)


def mlstm_decode_init(cfg: ModelConfig, batch: int, device=None, full=None) -> MLSTMState:
    h, hd = _heads(cfg)
    return MLSTMState(c=_full((batch, h, hd, hd), 0.0, device, full),
                      n=_full((batch, h, hd), 0.0, device, full),
                      m=_full((batch, h), NEG_INIT, device, full))


def _mlstm_scan(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                shd: ShardingConfig = NO_SHARDING):
    """The exact recurrence over x's sequence → (hidden states (B, S, H, hd),
    the output gate, the final state).  On a mesh it runs on each rank's
    (batch, heads) piece (``layers.scan_on_pieces``)."""
    q, k, v, it, logf, og = _mlstm_qkvif(cfg, p, x, shd)
    inputs = (q.float(), k.float(), v.float(), it, logf)
    if L.is_dtensor(x):
        hs, *state = L.scan_on_pieces(shd, _heads(cfg)[0], _mlstm_loop, inputs, (), 3)
        return hs, og, MLSTMState(*state)
    hs, state = _mlstm_loop(*inputs)
    return hs, og, state


def _mlstm_loop(q, k, v, it, logf):
    """The mLSTM recurrence over plain (B, S, H, ·) tensors → (hidden states
    (B, S, H, hd), the final state)."""
    b, _, h, hd = q.shape
    state = MLSTMState(c=torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device),
                       n=torch.zeros((b, h, hd), dtype=torch.float32, device=q.device),
                       m=torch.full((b, h), NEG_INIT, dtype=torch.float32, device=q.device))
    hs = []
    # unbind, not x[:, t]: its backward is one stack, where each step's
    # select would make a whole (B, S, ...) gradient of zeros
    for step in zip(*(t.unbind(1) for t in (q, k, v, it, logf))):
        state, h_t = mlstm_step(state, *step)
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def _mlstm_out(p: MLSTM, hs: torch.Tensor, og: torch.Tensor, x: torch.Tensor,
               shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    b, s = hs.shape[:2]
    y = L.shard((hs * og).reshape(b, s, -1).to(x.dtype), shd, L.dp(shd), None, shd.tp)
    return F.linear(y, p.w_out)


def mlstm_forward(cfg: ModelConfig, p: MLSTM, x: torch.Tensor, return_state: bool = False,
                  shd: ShardingConfig = NO_SHARDING):
    """Training path: the exact recurrence over the sequence.  x (B, S, d)
    → (B, S, d), and with ``return_state`` the final ``MLSTMState``."""
    p = L.Gathered(p, shd) if shd.enabled else p
    hs, og, state = _mlstm_scan(cfg, p, x, shd)
    out = _mlstm_out(p, hs, og, x, shd)
    return (out, state) if return_state else out


def mlstm_prefill_state(cfg: ModelConfig, p: MLSTM, x: torch.Tensor) -> MLSTMState:
    """Final recurrent state after processing x (prefill priming)."""
    return _mlstm_scan(cfg, p, x)[2]


def mlstm_forward_chunked(cfg: ModelConfig, p: MLSTM, x: torch.Tensor,
                          shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """Chunkwise-parallel stabilized mLSTM (the reference's §Perf training
    path): the matrix state is kept per chunk of MLSTM_CHUNK, not per step,
    and the interactions within a chunk are masked quadratic einsums.  Equal
    to ``mlstm_forward`` up to the order of f32 sums.

    Scaled-state bookkeeping (per head): carry (S̃, ñ, m) with the true
    state C = S̃·eᵐ.  Within a chunk, with F_t = Σ_{≤t} log f, g_j =
    i_j − F_j, M_t = cummax g, mx_t = max(m, M_t):
        h_t = [Σ_{j≤t} e^{g_j−mx_t}(q_t·k_j)v_j + e^{m−mx_t}(q_t·S̃)]
              / max(|analogous n-sum|, e^{−(F_t+mx_t)})
    and the carry advances with mx_L = max(m, M_L):
        S̃' = S̃·e^{m−mx_L} + Σ_j e^{g_j−mx_L} k_j v_jᵀ ,  m' = F_L + mx_L.
    """
    p = L.Gathered(p, shd) if shd.enabled else p
    b, s, _ = x.shape
    h, hd = _heads(cfg)
    q, k, v, it, logf, og = _mlstm_qkvif(cfg, p, x, shd)
    chunk = min(MLSTM_CHUNK, s)
    if s % chunk:
        raise ValueError(f"mlstm_forward_chunked: {s} tokens are not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk

    def resh(t):
        return t.reshape(b, nc, chunk, *t.shape[2:]).float()

    qc, kc, vc = resh(q), resh(k), resh(v)             # (B, NC, Q, H, hd)
    itc, lfc = resh(it), resh(logf)                    # (B, NC, Q, H)
    F_ = torch.cumsum(lfc, dim=2)
    g = itc - F_
    M = torch.cummax(g, dim=2).values
    btot = F_[:, :, -1, :]                             # (B, NC, H)
    causal = L.replicate_like(
        torch.ones((chunk, chunk), dtype=torch.bool, device=L.local(x).device).tril(), x)
    causal = causal[None, :, :, None]

    S, n, m = mlstm_decode_init(cfg, b, L.local(x).device, _beside(x))
    hs = []
    # the chunks by unbind, as the recurrences' steps (one stack backward)
    for qb, kb, vb, Fb, gb, Mb, bl in zip(*(t.unbind(1) for t in (qc, kc, vc, F_, g, M, btot))):
        mx = torch.maximum(m[:, None], Mb)             # (B, Q, H)
        wmat = torch.exp(gb[:, None, :, :] - mx[:, :, None, :])
        wmat = torch.where(causal, wmat, torch.zeros_like(wmat))   # (B, Tq, Tj, H)
        scores = torch.einsum("bqhd,bjhd->bqjh", qb, kb) * wmat
        inter = torch.exp(m[:, None] - mx)             # (B, Q, H)
        numer = (torch.einsum("bqjh,bjhd->bqhd", scores, vb)
                 + inter[..., None] * torch.einsum("bqhk,bhkv->bqhv", qb, S))
        qn = scores.sum(dim=2) + inter * torch.einsum("bqhk,bhk->bqh", qb, n)
        floor = torch.exp(torch.minimum(-(Fb + mx), _const(60.0, mx)))
        hs.append(numer / torch.maximum(torch.abs(qn), floor)[..., None])
        # the carry's advance
        mxl = torch.maximum(m, Mb[:, -1])              # (B, H)
        wl = torch.exp(gb - mxl[:, None])              # (B, Q, H)
        decay = torch.exp(m - mxl)
        S = S * decay[..., None, None] + torch.einsum("bjh,bjhk,bjhv->bhkv", wl, kb, vb)
        n = n * decay[..., None] + torch.einsum("bjh,bjhk->bhk", wl, kb)
        m = bl + mxl
    hs = torch.stack(hs, dim=1).reshape(b, s, h, hd)
    return _mlstm_out(p, hs, og, x, shd)


def mlstm_decode_step(cfg: ModelConfig, p: MLSTM, x: torch.Tensor, state: MLSTMState,
                      shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, MLSTMState]:
    """x (B, 1, d) → (out (B, 1, d), the new state)."""
    p = L.Gathered(p, shd) if shd.enabled else p
    q, k, v, it, logf, og = _mlstm_qkvif(cfg, p, x, shd)
    state, h_t = mlstm_step(state, q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                            it[:, 0], logf[:, 0])
    return _mlstm_out(p, h_t[:, None], og, x), state


# ---------------------------------------------------------------- sLSTM ----


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd) cell
    n: torch.Tensor   # (B, H, hd) normalizer
    m: torch.Tensor   # (B, H, hd) stabilizer
    h: torch.Tensor   # (B, H, hd) hidden (the recurrent input)


GATES = ("z", "i", "f", "o")


class SLSTM(nn.Module):
    """``slstm_init``: per gate g in z, i, f, o the input weight ``w<g>``
    (d → H·hd) and the head-local recurrent matrix ``r<g>`` (H, hd, hd) ~
    N(0, 1/hd), all f32; ``w_out`` (d → d) in the config's dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        h, hd = _heads(cfg)
        for g in GATES:
            setattr(self, f"w{g}", L._empty((h * hd, d), torch.float32, device))
            setattr(self, f"r{g}", L._empty((h, hd, hd), torch.float32, device))
        self.w_out = L._empty((d, d), L.param_dtype(cfg), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for g in GATES:
            L.dense_init_(getattr(self, f"w{g}"), gen)
            r = getattr(self, f"r{g}")
            z = torch.randn(r.shape, generator=gen, device=r.device, dtype=torch.float32)
            r.copy_(z.mul_(1.0 / math.sqrt(r.shape[-1])))
        L.dense_init_(self.w_out, gen)


def slstm_step(p: SLSTM, state: SLSTMState, xz, xi, xf, xo):
    """All inputs (B, H, hd) f32 pre-activations from x."""
    def rec(g):
        return torch.einsum("bhk,hkv->bhv", state.h, getattr(p, f"r{g}"))

    zt = torch.tanh(xz + rec("z"))
    it = xi + rec("i")                                 # log-space input gate
    ft = _logsigmoid(xf + rec("f"))                    # log forget gate
    ot = torch.sigmoid(xo + rec("o"))
    m_new = torch.maximum(ft + state.m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + state.m - m_new)
    c = f_ * state.c + i_ * zt
    n = f_ * state.n + i_
    h_new = ot * c / torch.maximum(n, _const(1.0, n))
    return SLSTMState(c, n, m_new, h_new), h_new


def _slstm_inputs(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                  shd: ShardingConfig = NO_SHARDING):
    h, _ = _heads(cfg)
    xf32 = x.float()
    return tuple(L.split_heads(F.linear(xf32, getattr(p, f"w{g}")), h, shd) for g in GATES)


def slstm_decode_init(cfg: ModelConfig, batch: int, device=None, full=None) -> SLSTMState:
    h, hd = _heads(cfg)
    shape = (batch, h, hd)
    return SLSTMState(c=_full(shape, 0.0, device, full), n=_full(shape, 0.0, device, full),
                      h=_full(shape, 0.0, device, full),
                      m=_full(shape, NEG_INIT, device, full))


def _slstm_scan(cfg: ModelConfig, p: SLSTM, x: torch.Tensor,
                shd: ShardingConfig = NO_SHARDING):
    """The sLSTM recurrence over x's sequence → (hidden states (B, S, H, hd),
    the final state); on a mesh on each rank's piece
    (``layers.scan_on_pieces``)."""
    inputs = _slstm_inputs(cfg, p, x, shd)
    weights = tuple(getattr(p, f"r{g}") for g in GATES)
    if L.is_dtensor(x):
        hs, *state = L.scan_on_pieces(shd, _heads(cfg)[0], _slstm_loop, inputs, weights, 4)
        return hs, SLSTMState(*state)
    return _slstm_loop(*inputs, *weights)


def _slstm_loop(xz, xi, xf, xo, *r):
    """The sLSTM recurrence over plain (B, S, H, hd) pre-activations with
    the recurrent weights ``r`` (one (H, hd, hd) a gate) → (hidden states,
    the final state)."""
    b, _, h, hd = xz.shape
    p = SimpleNamespace(**{f"r{g}": w for g, w in zip(GATES, r)})

    def zeros():
        return torch.zeros((b, h, hd), dtype=torch.float32, device=xz.device)

    state = SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                       m=torch.full((b, h, hd), NEG_INIT, dtype=torch.float32, device=xz.device))
    hs = []
    for step in zip(*(t.unbind(1) for t in (xz, xi, xf, xo))):
        state, h_t = slstm_step(p, state, *step)
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def slstm_forward(cfg: ModelConfig, p: SLSTM, x: torch.Tensor, return_state: bool = False,
                  shd: ShardingConfig = NO_SHARDING):
    """x (B, S, d) → (B, S, d), and with ``return_state`` the final
    ``SLSTMState``."""
    p = L.Gathered(p, shd) if shd.enabled else p
    hs, state = _slstm_scan(cfg, p, x, shd)
    out = F.linear(L.merge_heads(hs.to(x.dtype), shd), p.w_out)
    return (out, state) if return_state else out


def slstm_prefill_state(cfg: ModelConfig, p: SLSTM, x: torch.Tensor) -> SLSTMState:
    return _slstm_scan(cfg, p, x)[1]


def slstm_decode_step(cfg: ModelConfig, p: SLSTM, x: torch.Tensor, state: SLSTMState,
                      shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, SLSTMState]:
    p = L.Gathered(p, shd) if shd.enabled else p
    xz, xi, xf, xo = _slstm_inputs(cfg, p, x, shd)
    state, h_t = slstm_step(p, state, xz[:, 0], xi[:, 0], xf[:, 0], xo[:, 0])
    return F.linear(L.merge_heads(h_t[:, None].to(x.dtype), shd), p.w_out), state
