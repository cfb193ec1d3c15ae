"""Shared neural layers — port of ``repro.models.layers``: norms, RoPE,
GQA attention (full / sliding / chunked masks; naive, chunked-query and
flash implementations), the GLU MLP and the embeddings.

Parameters live in ``nn.Module``s built on the target device and filled
from an explicit ``torch.Generator`` with the reference's distributions.
A dense weight is stored (out, in), ``nn.Linear``'s layout, where the
reference stores (in, out); ``interop.backbone_params_from_numpy``
transposes.  Cross-attention passes the encoder's K/V as
``kv_override``: only q is projected, and the path is naive (or
chunked-query), as in the reference.

Sharding, as the reference's: each layer takes ``shd`` (a
``ShardingConfig``, keyword, default ``NO_SHARDING``) and constrains its
activations at the reference's points through ``shard``.  A mesh is
ranks of ``torch.distributed``, and a sharded tensor a DTensor on its
``DeviceMesh``: ``shard`` redistributes a DTensor to the spec's
placements (the counterpart of ``with_sharding_constraint``) and returns
a plain tensor as it is, so an unsharded call computes exactly what it
did before.  Where the reference reads the ambient mesh, the port reads
the DTensor's own (``tp_size``); ``_attn_flash`` on DTensors runs the
kernel on each rank's (batch, heads) piece through ``local_map``, the
counterpart of ``shard_map``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_mask
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig
from repro_torch.models.sharding import placements_for

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NEG = -1e30


# -- sharding helpers ----------------------------------------------------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, shd: ShardingConfig, *spec) -> torch.Tensor:
    """A sharding constraint: a DTensor redistributed to ``spec``'s
    placements on its own mesh (an axis name dropped where it does not
    divide the dimension); a plain tensor, or a spec naming an axis the
    mesh lacks, leaves ``x`` as it is (the reference's caught error)."""
    if not shd.enabled or not is_dtensor(x):
        return x
    names = x.device_mesh.mesh_dim_names
    for entry in spec:
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if axis not in names:
                return x
    placements = placements_for(x.shape, spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def gathered(w: Optional[torch.Tensor], shd: ShardingConfig) -> Optional[torch.Tensor]:
    """A parameter whole over the fsdp axes, its model-axis split kept:
    FSDP's all-gather of a layer's weights before their use, as GSPMD
    gathers the reference's.  Without it DTensor contracts over the
    fsdp-split dimension instead, making partial sums of the whole batch's
    activations on every rank and reduce-scattering them.  The gradient
    comes back reduce-scattered onto the pieces.  A plain tensor (or None)
    as it is, and an axis of one rank left alone (its one piece is whole)."""
    if w is None or not shd.enabled or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    pl = tuple(Replicate() if mesh.mesh_dim_names[m] in shd.fsdp and mesh.size(m) > 1 else p
               for m, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """``F.linear`` on the parameters ``gathered`` over the fsdp axes."""
    if is_dtensor(x) and not x.to_local().is_contiguous():
        # DTensor's linear views its local piece, which a redistribution
        # that padded an uneven split leaves strided (its ``contiguous``
        # keeps that piece)
        from torch.distributed.tensor import DTensor

        x = DTensor.from_local(x.to_local().contiguous(), x.device_mesh, x.placements,
                               run_check=False, shape=x.shape, stride=x.stride())
    return F.linear(x, gathered(w, shd), gathered(b, shd))


class Gathered:
    """A module's parameters, each ``gathered`` at its first use (once
    per wrapper, so a recurrence's loop gathers nothing again); a plain
    module's as they are."""

    def __init__(self, module: nn.Module, shd: ShardingConfig):
        self._module, self._shd, self._memo = module, shd, {}

    def __getattr__(self, name):
        if name not in self._memo:
            value = getattr(self._module, name)
            self._memo[name] = (gathered(value, self._shd) if isinstance(value, torch.Tensor)
                                else value)
        return self._memo[name]


def merge_heads(y: torch.Tensor, shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """Heads (B, S, n, w) flattened to (B, S, n·w) and split over the model
    axis, as the reference constrains an attention output: a head count the
    axis does not divide leaves the heads whole, and the flat dimension's
    split (with its redistribution's backward) keeps the gradient's head
    view possible."""
    b, s = y.shape[:2]
    return shard(y.reshape(b, s, -1), shd, dp(shd), None, shd.tp)


def split_heads(y: torch.Tensor, n: int, shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """A projection's output (B, S, n·w) viewed as n heads (B, S, n, w).
    On a mesh the output is split over the model axis; the head view needs
    whole heads on every rank, so the model axis stays on it only where it
    divides the head count (8 KV heads on a 16-wide axis: replicated)."""
    y = shard(y, shd, dp(shd), None, tp_if_divisible(shd, n, y))
    return y.reshape(*y.shape[:2], n, y.shape[2] // n)


def batch_head_placements(shd: ShardingConfig, like: torch.Tensor, h: int) -> tuple:
    """Placements of a (B, S, H, ·) tensor on ``like``'s mesh for work on
    each rank's own rows and heads (a recurrence, a scan): the batch over
    the data axes where they divide it, the heads over the model axis where
    it divides them, else whole."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, out = like.device_mesh, []
    for m, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(m)
        if name in shd.fsdp and like.shape[0] % size == 0:
            out.append(Shard(0))
        elif name == shd.tp and h % size == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def moved(placements, dims: dict, partial: bool = False) -> tuple:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dims[d])``; a
    split dimension with no place in ``dims`` becomes ``Replicate()``, or
    with ``partial`` ``Partial()`` (the gradient of a tensor that each of
    those ranks used on its own rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple((Shard(dims[p.dim]) if p.dim in dims else (Partial() if partial else Replicate()))
                 if p.is_shard() else p for p in placements)


def scan_on_pieces(shd: ShardingConfig, h: int, loop, inputs, weights, n_state: int):
    """``loop(*inputs, *weights)`` → (hidden states, state) on each rank's
    piece through ``local_map``: the (B, S, H, ·) inputs placed by
    ``batch_head_placements``, the (H, ·) weights by their heads (whole over
    the data axes; their gradient a partial sum there), and no DTensor op
    inside the recurrence, so every step runs the same local ops and the
    scan sends nothing.  Returns the hidden states and the ``n_state``
    state leaves ((B, H, ...), placed by their batch and heads; a state of
    one tensor or a tuple of them)."""
    from torch.distributed.tensor.experimental import local_map

    like = inputs[0]
    pl = batch_head_placements(shd, like, h)
    st_pl = moved(pl, {0: 0, 2: 1})
    w_pl, w_grad = moved(pl, {2: 0}), moved(pl, {2: 0}, partial=True)
    inputs = [with_placements(t, like, pl) for t in inputs]
    weights = [with_placements(w, like, w_pl) for w in weights]

    def flat(*args):
        hs, state = loop(*args)
        return (hs, *(state if isinstance(state, tuple) else (state,)))

    return local_map(flat, out_placements=(pl,) + (st_pl,) * n_state,
                     in_placements=(pl,) * len(inputs) + (w_pl,) * len(weights),
                     in_grad_placements=(pl,) * len(inputs) + (w_grad,) * len(weights),
                     device_mesh=like.device_mesh)(*inputs, *weights)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor (positions, RoPE frequencies, masks: the same on every rank);
    else ``t`` as it is."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's piece of a DTensor (a view of its storage); a plain
    tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def mesh_of(x: torch.Tensor):
    """The ``DeviceMesh`` of a DTensor, None for a plain tensor."""
    return x.device_mesh if is_dtensor(x) else None


def local_offset(x: torch.Tensor, dim: int) -> int:
    """Where this rank's piece of ``x`` starts along ``dim`` of the whole
    tensor (0 for a plain tensor).  A dimension split over several mesh
    axes is split by the first, then each piece by the next, as DTensor
    splits it; the specs split only dimensions they divide evenly."""
    if not is_dtensor(x):
        return 0
    mesh, coords = x.device_mesh, x.device_mesh.get_coordinate()
    size, off = x.shape[dim], 0
    for mdim, p in enumerate(x.placements):
        if p.is_shard(dim):
            size //= mesh.size(mdim)
            off += coords[mdim] * size
    return off


def with_placements(x: torch.Tensor, like: torch.Tensor, placements) -> torch.Tensor:
    """``x`` as a DTensor on ``like``'s mesh with ``placements`` (a plain
    ``x``, the same on every rank, is replicated first: no communication)."""
    x = replicate_like(x, like)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def dp(shd: ShardingConfig):
    """Batch/fsdp axes tuple (possibly multi-axis: ('pod','data'))."""
    return shd.fsdp if shd.fsdp else None


def tp_size(shd: ShardingConfig, x: torch.Tensor) -> int:
    """Extent of the tensor-parallel axis in the mesh of ``x`` (1 for a
    plain tensor: no mesh)."""
    if not shd.enabled or shd.tp is None or not is_dtensor(x):
        return 1
    names = x.device_mesh.mesh_dim_names or ()
    return x.device_mesh.size(names.index(shd.tp)) if shd.tp in names else 1


def tp_if_divisible(shd: ShardingConfig, dim: int, x: torch.Tensor):
    """'model' axis name if it divides ``dim`` evenly in ``x``'s mesh, else
    None (8 kv heads on a 16-way model axis → replicate kv, shard q
    heads)."""
    t = tp_size(shd, x)
    return shd.tp if (t > 1 and dim % t == 0) else None


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
    flash kernel's mask, so every attention path masks alike).  Replicated
    positions give a replicated mask."""
    mask = attention_mask(local(q_pos), local(k_pos), cfg.attention, cfg.window, causal,
                          is_global)
    return replicate_like(mask, q_pos)


def qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor,
        freqs: torch.Tensor, causal: bool = True, use_rope: bool = True,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        shd: ShardingConfig = NO_SHARDING
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projected q (B, S, H, hd) and k, v (B, S, KV, hd), RoPE applied to
    q and k of causal self-attention with ``use_rope``.  With
    ``kv_override`` (cross-attention) only q is projected and k, v are
    the override's, unrotated."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = split_heads(linear(x, p.wq, p.bq, shd), h, shd)
    rope = causal and use_rope     # RoPE on self-attention only (Whisper: none)
    if kv_override is None:
        k = split_heads(linear(x, p.wk, p.bk, shd), kv, shd)
        v = split_heads(linear(x, p.wv, p.bv, shd), kv, shd)
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
           kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           shd: ShardingConfig = NO_SHARDING
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mha`` that also returns this layer's k and v (post-RoPE), which
    prefill writes into the cache."""
    b, s, _ = x.shape
    q, k, v = qkv(cfg, p, x, positions, freqs, causal, use_rope, kv_override, shd)
    if kv_override is None:
        k_pos = positions[0]
    else:
        k_pos = torch.arange(k.shape[1], device=x.device)
    if (cfg.attn_impl == "flash" and kv_override is None
            and s == k.shape[1] and s % 128 == 0):
        out = _attn_flash(cfg, shd, q, k, v, is_global, causal)
    elif cfg.attn_impl == "chunked_q":
        out = _attn_chunked_q(cfg, shd, q, k, v, positions, k_pos, is_global, causal)
    else:
        out = _attn_naive(cfg, shd, q, k, v, positions, k_pos, is_global, causal)
    out = out.reshape(b, s, cfg.num_heads * cfg.hd)
    out = shard(out, shd, dp(shd), None, shd.tp)
    return linear(out, p.wo, shd=shd), k, v


def mha(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor,
        freqs: torch.Tensor, is_global: bool, causal: bool = True,
        use_rope: bool = True,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """x: (B, S, d); positions: (B, S); ``kv_override`` (k, v), each (B,
    Sk, KV, hd), attends to them at key positions 0..Sk-1.  Flash is
    taken when ``attn_impl == "flash"``, there is no override and S is a
    multiple of 128, as in the reference; otherwise the naive path."""
    return mha_kv(cfg, p, x, positions, freqs, is_global, causal, use_rope, kv_override,
                  shd)[0]


def _attn_naive(cfg, shd, q, k, v, positions, k_pos, is_global, causal):
    """Paper-faithful baseline: full (…,S,S) score materialization, the
    queries folded by KV head.  On a mesh each rank attends with its own
    (batch, heads) piece through ``local_map`` (``head_pieces``), the
    unsharded op on it: DTensor's rules for the grouped einsums would flatten
    a batch and a head dimension that are both split."""
    fn = _naive_local(cfg, is_global, causal)
    if not is_dtensor(q):
        return fn(q, k, v, positions[0], k_pos)
    from torch.distributed.tensor.experimental import local_map

    q, k, v = head_pieces(shd, q, k, v)
    pl = tuple(q.placements)

    def on_pieces(q, k, v, q_pos, k_pos):
        # the pieces' gradients leave contiguous (DTensor views them) and
        # the heads come back flat (B, S, H·hd)
        q, k, v = (_ContiguousGrad.apply(x) for x in (q, k, v))
        return fn(q, k, v, q_pos, k_pos).flatten(2)

    return local_map(on_pieces, out_placements=list(pl), in_placements=(pl, pl, pl, None, None),
                     in_grad_placements=(pl, pl, pl, None, None), device_mesh=q.device_mesh)(
        q, k, v, local(positions[0]), local(k_pos))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous: DTensor's ops on a
    gradient piece view it as its global layout says, which a piece that an
    einsum's backward left strided does not match."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _naive_local(cfg, is_global, causal):
    """The naive attention on plain (B, S, ·, hd) tensors → (B, S, KV, G, hd)."""

    def attend(q, k, v, q_pos, k_pos):
        b, s, _, hd = q.shape
        qg = q.reshape(b, s, k.shape[2], -1, hd)          # grouped-query folding
        scores = torch.einsum("bsgqh,btgh->bgqst", qg, k).float() / math.sqrt(hd)
        mask = attention_mask(q_pos, k_pos, cfg.attention, cfg.window, causal, is_global)
        scores = scores.masked_fill(~mask, NEG)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bgqst,btgh->bsgqh", w, v)

    return attend


def head_pieces(shd: ShardingConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B, S, H, hd) and k, v (B, S, KV, hd) placed alike for attention on
    each rank's heads: the batch over the data axes, the heads over the
    model axis where it divides the query heads, else whole.  Where it
    divides the query heads but not the KV heads (8 KV heads on a 16-wide
    axis) the KV heads are expanded to full heads first (``_expand_kv``, a
    local broadcast of the replicated K/V): no gather, the per-rank work of
    GSPMD's factored (KV, group) split."""
    h = q.shape[2]
    tq = tp_if_divisible(shd, h, q)
    if tq and not tp_if_divisible(shd, k.shape[2], k):
        k, v = _expand_kv(k, v, h)
    q = shard(q, shd, dp(shd), None, tq, None)
    return (q, *(with_placements(x, q, q.placements) for x in (k, v)))


def _expand_kv(k: torch.Tensor, v: torch.Tensor, h: int):
    """GQA → full heads (each KV head repeated for its query group), as a
    broadcast and a reshape: ``repeat_interleave``'s result, and views
    that keep a DTensor's head sharding (``repeat_interleave`` has no
    sharding rule)."""
    b, s, kvh, hd = k.shape
    if kvh == h:
        return k, v
    grow = lambda x: x[:, :, :, None].expand(b, s, kvh, h // kvh, hd).reshape(  # noqa: E731
        b, s, h, hd)
    return grow(k), grow(v)


def _flash_local(cfg, is_global, causal):
    """The flash kernels on (B, S, H, hd) pieces, folded to (B·H, S, hd)."""
    window = cfg.window if cfg.attention in ("sliding", "chunked") else 0

    def local(q, k, v):
        b, s, h, hd = q.shape
        fold = lambda x: x.transpose(1, 2).reshape(b * h, s, hd).contiguous()   # noqa: E731
        o = ops.flash_attention_nhsd(fold(q), fold(k), fold(v), cfg.attention,
                                     window, causal, bool(is_global))
        return o.reshape(b, h, s, hd).transpose(1, 2)

    return local


def _attn_flash(cfg, shd, q, k, v, is_global, causal):
    """The flash-attention kernels on (B·H, S, hd): KV heads expanded to
    full heads and folded with the batch.  Differentiable: the backward of
    the expansion sums dK and dV over each query group, as
    ``jnp.repeat``'s does.  On DTensors (a mesh) the heads are padded to
    a multiple of the model axis, the kernel runs on each rank's (batch,
    heads) piece through ``local_map`` (the reference's ``shard_map``),
    and the padding is sliced off."""
    b, s, h, hd = q.shape
    k, v = _expand_kv(k, v, h)
    local = _flash_local(cfg, is_global, causal)
    if not is_dtensor(q):
        return local(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    t = tp_size(shd, q)
    h_pad = -(-h // t) * t
    if h_pad != h:
        # pad on replicated heads, then split them over the model axis
        q, k, v = (F.pad(shard(x, shd, dp(shd), None, None, None), (0, 0, 0, h_pad - h))
                   for x in (q, k, v))
    q, k, v = (shard(x, shd, dp(shd), None, shd.tp, None) for x in (q, k, v))
    placements = q.placements
    k, v = (x.redistribute(q.device_mesh, placements) for x in (k, v))
    out = local_map(local, out_placements=list(placements), in_placements=(placements,) * 3,
                    device_mesh=q.device_mesh)(q, k, v)
    return out[:, :, :h] if h_pad != h else out


def _attn_chunked_q(cfg, shd, q, k, v, positions, k_pos, is_global, causal):
    """Query chunks of ``attn_q_chunk`` rows, each an exact row softmax:
    scores residency (b, h, Qc, S) per chunk instead of (b, h, S, S)."""
    b, s, h, hd = q.shape
    k, v = _expand_kv(k, v, h)
    q, k, v = (shard(x, shd, dp(shd), None, shd.tp, None) for x in (q, k, v))
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


def mlp(cfg: ModelConfig, p: GLU, x: torch.Tensor,
        shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    hdn = _act(cfg, linear(x, p.w_gate, shd=shd)) * linear(x, p.w_up, shd=shd)
    return linear(shard(hdn, shd, dp(shd), None, shd.tp), p.w_down, shd=shd)


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


def embed(cfg: ModelConfig, p: Embed, tokens: torch.Tensor,
          shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    e = _embed_replicated(p.tok, tokens) if is_dtensor(p.tok) else p.tok[tokens]
    return shard(e, shd, dp(shd), None, None)


def _embed_replicated(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup on a mesh: the (vocab- and fsdp-sharded) table replicated
    (an all-gather, where GSPMD gathers too) and indexed on each rank's
    tokens through ``local_map``, the unsharded op itself.  DTensor's rule
    for the lookup's backward (``index_put`` into a sharded table) fails in
    torch 2.11.  The table's gradient is a partial sum over the mesh axes
    that split the tokens and the same on the others."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = tok.device_mesh
    if not is_dtensor(tokens):
        tokens = replicate_like(tokens, tok)
    rep = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in tokens.placements)
    idx = tuple(tokens.placements)
    return local_map(lambda t, i: t[i], out_placements=list(idx), in_placements=(rep, idx),
                     in_grad_placements=(grad, idx), device_mesh=mesh)(
        tok.redistribute(mesh, rep), tokens)


def unembed(cfg: ModelConfig, p: Embed, x: torch.Tensor,
            shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    logits = linear(x, p.tok if cfg.tie_embeddings else p.out, shd=shd)
    return shard(logits, shd, dp(shd), None, shd.tp)
