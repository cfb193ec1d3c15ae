"""Agent-network backbone — port of ``repro.models.backbone``, all six
families: dense, moe, vlm, hybrid, ssm and audio.

Paths:
  * ``forward``     — full-sequence (training / prefill) logits
  * ``init_cache`` / ``prefill`` / ``decode_step`` — KV/state-cached serving
    (the paper's actor ``act()`` at LM scale)

Structure, the units an ``nn.ModuleList`` of ``nn.ModuleDict``s keyed by
sub-layer kind:
  dense / vlm      embed(+patches) → units[attn → mlp] → norm → unembed
  moe (mixtral)    units[attn → moe]
  moe (llama4)     units[attn → mlp → attn → moe]
  hybrid (hymba)   units[(attn ∥ mamba) → mlp]   (parallel heads, averaged)
  ssm (xlstm)      blocks[norm → mLSTM | sLSTM → mlp] (sLSTM at cfg.slstm_at)
  audio (whisper)  frames + enc_pos → enc_units[attn_nc → mlp] → enc_norm;
                   embed → dec_units[attn → cross → mlp] → norm → unembed
A hybrid unit's cache holds its attention's K/V and its SSM state
(``"ssm"``, (n_units, B, H, N, P) f32); an ssm model's cache holds each
block's recurrent state (``"blocks"``, as the reference's); an audio
model's adds each decoder layer's cross-attention K/V over the encoder
output (``"cross_k"``/``"cross_v"``, (L, B, encoder_seq, KV, hd)).

Whisper as the reference builds it: the conv frontend is a stub (the
caller passes frame embeddings (B, encoder_seq, d) as ``extra_embeds``),
``enc_pos`` is a learned table initialized at zero, the encoder's
self-attention is non-causal (``attn_nc``), no attention rotates (the
decoder has no positional signal at all), and cross-attention reads K/V
projected from the normed encoder output without biases.  The logits are
the decoder's (B, S_text, V).

A Llama-4 unit has two attention sub-layers and ONE set of attention
weights: the reference's ``_unit_init`` writes ``p[kind]`` for each kind
of ``("attn", "mlp", "attn", "moe")``, so the second ``"attn"`` replaces
the first and ``_apply_sub`` reads ``p["attn"]`` for both.  The port
keeps it so: a unit's ModuleDict holds each kind once, and both
attention sub-layers read ``unit["attn"]`` (each keeps its own KV cache
entry).  The moe sub-layers' metrics are discarded, as ``_apply_sub``
does (``moe.recording()`` reads them).  vlm's ``extra_embeds`` (B, P, d)
are prepended to the embedded tokens, as the reference's ``forward``
and ``prefill`` do.

Differences from the reference, each for one card and eager PyTorch:
  * the cache's ``pos`` is a vector, one position per batch row, so each
    row of a batched decode has its own RoPE phase, cache write and
    causal mask (the reference keeps one scalar and the serve engine
    vmaps a batch of 1 over the slots);
  * ``decode_step`` writes the cache in place and returns it; with
    ``write_mask`` a masked-out row is left exactly as it was, ``pos``
    included.  Its moe layers route with ``drop=False``: each row gets
    what the reference engine's per-slot call gives it, where a
    capacity over the batch could drop tokens (``models/moe.py``);
  * ``prefill`` runs the stack once and keeps each attention layer's
    post-RoPE K/V from that pass, where the reference runs ``forward``
    and then ``_capture_kv_states`` (two passes).  The numbers are the
    same: the captured K/V are the ones the attention used.  So a
    prefill launches the flash kernel once per attention layer.  Whisper's
    ``prefill`` runs the encoder once and the decoder once, keeping each
    decoder layer's self K/V and cross K/V, where the reference runs
    each twice;
  * remat, as the reference's ``jax.checkpoint`` of each unit: with
    ``cfg.remat`` and grad enabled, each unit of the stack runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    unit's input and runs the unit's forward again in the backward, flash
    kernel included.  So a training forward and backward launches the
    flash forward twice per attention layer and the dQ and dK/dV kernels
    once.  Whisper's encoder and decoder units are checkpointed alike.
    No-grad calls (the collect, the target network, ``prefill``
    and ``decode_step``) run the units as they are.  The xLSTM blocks are
    not units: the reference runs them unrolled without a checkpoint, and
    so does the port;
  * a decode step's ``write_mask`` holds back a row's recurrent state (the
    hybrid SSM state, the xLSTM block states) as it holds back its KV entry.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig
from repro_torch.models.sharding import canonical
from repro_torch.models.sharding import full as sharding_full

Cache = Dict[str, Any]

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
# Whisper's encoder unit; its decoder unit is ``unit_structure``'s
ENCODER_SUB = ("attn_nc", "mlp")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"{', '.join(FAMILIES)} only")


# ===========================================================================
# Modules and init
# ===========================================================================


class SubLayer(nn.Module):
    """One pre-norm residual sub-layer: ``{"norm", "w"}`` of the reference."""

    def __init__(self, cfg: ModelConfig, w: nn.Module, device=None):
        super().__init__()
        self.norm = L.Norm(cfg, cfg.d_model, device)
        self.w = w

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.w.reset_parameters(gen)


class HybridSub(nn.Module):
    """Hymba's ``hybrid`` sub-layer, the reference's tree: ``norm``, the
    attention ``attn`` (no ``w`` level), the SSM ``ssm`` and the norms of
    their outputs, ``norm_attn`` and ``norm_ssm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm = L.Norm(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ssm = M.Mamba(cfg, device)
        self.norm_attn = L.Norm(cfg, cfg.d_model, device)
        self.norm_ssm = L.Norm(cfg, cfg.d_model, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.attn.reset_parameters(gen)
        self.ssm.reset_parameters(gen)


def unit_structure(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(sub-layer kinds per unit, number of units); an ssm model has no
    units (its layers are ``Backbone.blocks``), an audio model's are its
    decoder's (``Backbone.dec_units``; its encoder's are ``ENCODER_SUB``)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return (), 0
    if cfg.family == "audio":
        return ("attn", "cross", "mlp"), cfg.num_layers
    if cfg.family == "hybrid":
        return ("hybrid", "mlp"), cfg.num_layers
    if cfg.family == "moe":
        if cfg.moe_layer_period == 1:
            return ("attn", "moe"), cfg.num_layers
        if cfg.moe_layer_period != 2:
            raise ValueError(f"{cfg.name}: moe_layer_period {cfg.moe_layer_period}; the "
                             "reference builds periods 1 and 2 only")
        return ("attn", "mlp", "attn", "moe"), cfg.num_layers // 2
    return ("attn", "mlp"), cfg.num_layers    # dense / vlm


def _make_sub(cfg: ModelConfig, kind: str, device) -> SubLayer:
    if kind in ("attn", "attn_nc", "cross"):
        return SubLayer(cfg, L.Attention(cfg, device), device)
    if kind == "mlp":
        return SubLayer(cfg, L.GLU(cfg, device=device), device)
    if kind == "moe":
        return SubLayer(cfg, MOE.MoE(cfg, device), device)
    if kind == "hybrid":
        return HybridSub(cfg, device)
    raise ValueError(kind)


def _make_block(cfg: ModelConfig, i: int, device) -> nn.ModuleDict:
    """xLSTM block ``i``: ``norm``, an ``slstm`` (at ``cfg.slstm_at``) or an
    ``mlstm``, and an ``mlp`` sub-layer of width (4·d)//3 or 2·d."""
    d = cfg.d_model
    if i in cfg.slstm_at:
        kind, cell, d_ff = "slstm", X.SLSTM(cfg, device), (d * 4) // 3
    else:
        kind, cell, d_ff = "mlstm", X.MLSTM(cfg, device), d * 2
    return nn.ModuleDict({"norm": L.Norm(cfg, d, device), kind: cell,
                          "mlp": SubLayer(cfg, L.GLU(cfg, d_ff=d_ff, device=device), device)})


def _block_kind(block: nn.ModuleDict) -> str:
    return "slstm" if "slstm" in block else "mlstm"


def _make_units(cfg: ModelConfig, sub: Tuple[str, ...], n_units: int,
                device) -> nn.ModuleList:
    return nn.ModuleList(nn.ModuleDict({kind: _make_sub(cfg, kind, device)
                                        for kind in dict.fromkeys(sub)})
                         for _ in range(n_units))


class Backbone(nn.Module):
    """``embed``, ``units`` (a ModuleList of ModuleDicts keyed by
    sub-layer kind, each kind once: a Llama-4 unit's two attention
    sub-layers share ``unit["attn"]``, as in the reference) or, for the
    ssm family, ``blocks`` (a ModuleList of ModuleDicts ``norm``,
    ``mlstm``|``slstm``, ``mlp``) or, for the audio family, ``enc_pos``
    (encoder_seq, d), ``enc_units`` ({``attn_nc``, ``mlp``} each),
    ``enc_norm`` and ``dec_units`` ({``attn``, ``cross``, ``mlp``} each),
    and ``final_norm`` — the reference's params tree, one module a layer
    where the reference stacks the layers."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        sub, n_units = unit_structure(cfg)
        self.embed = L.Embed(cfg, device)
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(_make_block(cfg, i, device)
                                        for i in range(cfg.num_layers))
        elif cfg.family == "audio":
            self.enc_pos = nn.Parameter(torch.zeros((cfg.encoder_seq, cfg.d_model),
                                                    dtype=L.param_dtype(cfg), device=device))
            self.enc_units = _make_units(cfg, ENCODER_SUB, cfg.encoder_layers, device)
            self.enc_norm = L.Norm(cfg, cfg.d_model, device)
            self.dec_units = _make_units(cfg, sub, n_units, device)
        else:
            self.units = _make_units(cfg, sub, n_units, device)
        self.final_norm = L.Norm(cfg, cfg.d_model, device)


def _units(cfg: ModelConfig, params: Backbone) -> nn.ModuleList:
    """The units of ``unit_structure``: Whisper's decoder's, or ``units``."""
    return params.dec_units if cfg.family == "audio" else params.units


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> Backbone:
    """Random weights, made on ``device`` (the generator's device) from
    ``gen`` with the reference's distributions: dense weights
    N(0, 1/d_in), the token embedding N(0, 0.02²), norms at scale 1 and
    bias 0, qkv biases 0, the experts as ``moe.MoE.reset_parameters``,
    the SSM's A_log 0, the sLSTM's recurrent matrices N(0, 1/hd) and
    Whisper's ``enc_pos`` 0."""
    device = gen.device if device is None else torch.device(device)
    model = Backbone(cfg, device)
    model.embed.reset_parameters(gen)
    if cfg.family == "ssm":
        layers = list(model.blocks)
    elif cfg.family == "audio":
        layers = [*model.enc_units, *model.dec_units]
    else:
        layers = list(model.units)
    for layer in layers:
        for s in layer.values():
            if not isinstance(s, L.Norm):
                s.reset_parameters(gen)
    return model


# ===========================================================================
# Sharding specs
# ===========================================================================

# the reference's layer stacks, each on a leading layer axis
STACKED = ("units", "enc_units", "dec_units")


def _reference_rule(cfg: ModelConfig, shd: ShardingConfig, names: List[str],
                    shape: Tuple[int, ...]) -> tuple:
    """``repro.models.backbone.param_specs``'s rule for the leaf at path
    ``names`` of (reference-layout) ``shape``, as a tuple."""
    fsdp = shd.fsdp if shd.fsdp else None
    tp = shd.tp
    name = names[-1]
    nd = len(shape)
    stacked = "units" in names or "blocks" in names
    base_nd = nd - 1 if stacked else nd

    def wrap(*spec):
        spec = spec + (None,) * (base_nd - len(spec))
        return ((None,) + spec) if stacked else spec

    if name in ("scale", "bias", "bq", "bk", "bv", "A_log", "w_dt", "enc_pos"):
        return wrap()
    if name == "tok":
        return wrap(tp, fsdp)
    if name == "out":
        return wrap(fsdp, tp)
    if name == "router":
        return wrap(fsdp, None)
    ep_ok = (shape[-3] % max(1, shd.tp_extent) == 0
             or not cfg.moe_ff_tp_fallback) if base_nd == 3 else True
    if base_nd == 3 and name in ("w_gate", "w_up"):     # MoE experts (E,d,f)
        return wrap(tp, fsdp, None) if ep_ok else wrap(None, fsdp, tp)
    if base_nd == 3 and name == "w_down":               # (E,f,d)
        return wrap(tp, None, fsdp) if ep_ok else wrap(None, tp, fsdp)
    if base_nd == 3 and name.startswith("r"):           # sLSTM (H,hd,hd)
        return wrap(tp, None, None)
    if name in ("wo", "w_down", "w_out"):               # row-parallel
        return wrap(tp, fsdp)
    if base_nd == 2:                                    # column-parallel
        return wrap(fsdp, tp)
    return wrap()


def reference_leaf(name: str, shape: Tuple[int, ...], n_stacked: int = 0
                   ) -> Tuple[List[str], Tuple[int, ...], bool, bool]:
    """The reference's view of the port's parameter ``name`` of ``shape``:
    (its path's keys, its shape in the reference's layout, whether it sits
    on a stacked layer axis of ``n_stacked`` layers, whether the port
    stores it transposed) — ``interop.backbone_leaf``'s mapping."""
    parts = name.split(".")
    if parts[0] in STACKED or parts[0] == "blocks":
        keys = [parts[0]] + ([f"[{parts[1]}]"] if parts[0] == "blocks" else []) + parts[2:]
        transposed = len(shape) == 2 and parts[-1] != "router"
        ref_shape = tuple(reversed(shape)) if transposed else tuple(shape)
        stacked = parts[0] in STACKED
        return keys, ((n_stacked,) + ref_shape) if stacked else ref_shape, stacked, transposed
    transposed = name == "embed.out"
    return parts, tuple(reversed(shape)) if transposed else tuple(shape), False, transposed


def _stack_depth(params: "Backbone", name: str) -> int:
    root = name.split(".")[0]
    return len(getattr(params, root)) if root in STACKED else 0


def to_port_spec(ref_spec: tuple, ref_ndim: int, stacked: bool, transposed: bool) -> tuple:
    """A reference-layout spec as the port's per-layer tensor takes it:
    one entry per reference dimension (a longer spec cut, as the
    reference's ``valid_spec`` cuts it), the layer axis dropped, and
    reversed where the port stores the leaf transposed.  Where the
    reference's rule gives a stacked layer axis a mesh axis (Whisper's
    stacks, which its ``"units" in names`` test takes for unstacked), the
    port's one-layer tensor has no such axis: that entry goes."""
    spec = (tuple(ref_spec) + (None,) * ref_ndim)[:ref_ndim]
    if stacked:
        spec = spec[1:]
    return tuple(reversed(spec)) if transposed else spec


def param_specs(cfg: ModelConfig, shd: ShardingConfig, params: "Backbone") -> Dict[str, tuple]:
    """{parameter name: spec} in ``params.named_parameters()`` order, each
    spec in the port's layout: the reference's ``param_specs`` rule (the
    stacked unit axis, EP against the d_ff-TP fallback for experts, the
    sLSTM ``r*`` leaves, row- against column-parallel) on the leaf's
    reference path and shape, then ``to_port_spec``.  ``params`` may live
    on the meta device (shapes only)."""
    out = {}
    for name, p in params.named_parameters():
        if not shd.enabled:
            out[name] = ()
            continue
        keys, ref_shape, stacked, transposed = reference_leaf(
            name, tuple(p.shape), _stack_depth(params, name))
        out[name] = canonical(to_port_spec(_reference_rule(cfg, shd, keys, ref_shape),
                                           len(ref_shape), stacked, transposed))
    return out


def shape_params(cfg: ModelConfig) -> "Backbone":
    """The model's parameters on the meta device: every shape and dtype,
    no storage (the full-size configs' spec and byte arithmetic)."""
    return Backbone(cfg, torch.device("meta"))


def _global_flags(cfg: ModelConfig, n_units: int, sub: Tuple[str, ...]) -> List[List[bool]]:
    """(n_units, n_attn_sublayers) — which attention sub-layers are global."""
    flags, idx = [], 0
    for _ in range(n_units):
        row = []
        for kind in sub:
            if kind in ("attn", "hybrid"):
                row.append(cfg.layer_is_global_attn(idx))
                idx += 1
        flags.append(row)
    return flags


def _positions(b: int, s: int, like: torch.Tensor) -> torch.Tensor:
    """(b, s) positions 0..s-1 on ``like``'s device (replicated on its mesh
    when it is a DTensor)."""
    return L.replicate_like(torch.arange(s, device=like.device).expand(b, s), like)


# ===========================================================================
# Forward (training / prefill)
# ===========================================================================


def _cross_kv(cfg: ModelConfig, p: L.Attention, enc: torch.Tensor,
              shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention K/V (B, S_enc, KV, hd), projected
    from the encoder output without biases, as the reference's."""
    b, se, _ = enc.shape
    shape = (b, se, cfg.num_kv_heads, cfg.hd)
    return (L.linear(enc, p.wk, shd=shd).reshape(shape),
            L.linear(enc, p.wv, shd=shd).reshape(shape))


def _unit(cfg: ModelConfig, sub: Tuple[str, ...], unit: nn.ModuleDict,
          flag_row: List[bool], x: torch.Tensor, positions: torch.Tensor,
          freqs: torch.Tensor, enc: Optional[torch.Tensor] = None,
          cap: Optional[Dict[str, list]] = None,
          shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """One unit's sub-layers (``enc``: the encoder output that a ``cross``
    sub-layer attends to); with ``cap`` each self-attention layer's K and
    V are appended to ``cap["k"]`` and ``cap["v"]``, each cross-attention
    layer's to ``cap["cross_k"]`` and ``cap["cross_v"]``, and each hybrid
    layer's final SSM state to ``cap["ssm"]``."""
    fi = 0
    for kind in sub:
        p = unit[kind]
        h = L.apply_norm(cfg, p.norm, x)
        if kind in ("attn", "hybrid"):
            y, k, v = L.mha_kv(cfg, p.w if kind == "attn" else p.attn, h, positions, freqs,
                               flag_row[fi], use_rope=cfg.family != "audio", shd=shd)
            fi += 1
            if cap is not None:
                cap["k"].append(k)
                cap["v"].append(v)
            if kind == "hybrid":    # Hymba: parallel attention + mamba heads, averaged
                s, st = M.mamba_scan(cfg, p.ssm, h, return_state=True, shd=shd)
                if cap is not None:
                    cap["ssm"].append(st)
                y = 0.5 * (L.apply_norm(cfg, p.norm_attn, y) + L.apply_norm(cfg, p.norm_ssm, s))
            x = x + y
        elif kind == "attn_nc":     # Whisper's encoder: non-causal, no RoPE
            x = x + L.mha(cfg, p.w, h, positions, freqs, True, causal=False, use_rope=False,
                          shd=shd)
        elif kind == "cross":
            ck, cv = _cross_kv(cfg, p.w, enc, shd)
            if cap is not None:
                cap["cross_k"].append(ck)
                cap["cross_v"].append(cv)
            x = x + L.mha(cfg, p.w, h, positions, freqs, True, causal=False,
                          kv_override=(ck, cv), shd=shd)
        elif kind == "moe":
            x = x + MOE.moe(cfg, p.w, h, shd=shd)[0]
        else:
            x = x + L.mlp(cfg, p.w, h, shd)
    return x


def _carry(x: torch.Tensor, shd: ShardingConfig) -> torch.Tensor:
    """The residual stream at a unit's (or block's) entry, its batch over
    the data axes and the rest whole: the one sharding that the
    reference's scan carries through every unit, so that on a mesh every
    unit runs the same ops (a plain tensor as it is)."""
    return L.shard(x, shd, L.dp(shd), None, None)


def _run_units(cfg: ModelConfig, units: nn.ModuleList, sub: Tuple[str, ...],
               x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
               enc: Optional[torch.Tensor] = None,
               cap: Optional[Dict[str, list]] = None,
               shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """A stack of units; with ``cap`` also what ``_unit`` captures.  With
    ``cfg.remat`` and grad enabled each unit is checkpointed."""
    flags = _global_flags(cfg, len(units), sub)
    remat = cfg.remat and torch.is_grad_enabled() and cap is None
    for unit, flag_row in zip(units, flags):
        x = _carry(x, shd)
        if remat:
            x = checkpoint(_unit, cfg, sub, unit, flag_row, x, positions, freqs, enc, None,
                           shd, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _unit(cfg, sub, unit, flag_row, x, positions, freqs, enc, cap, shd)
    return x


def _run_blocks(cfg: ModelConfig, params: Backbone, x: torch.Tensor,
                states: Optional[list] = None,
                shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """The xLSTM blocks (the reference's ``_xlstm_forward``).  With
    ``states`` each block's final recurrent state is appended as
    ``{kind: state}`` and every mLSTM block takes the exact scan, as the
    reference's ``prefill``; without, ``cfg.mlstm_chunked`` picks the
    chunkwise mLSTM."""
    for block in params.blocks:
        x = _carry(x, shd)
        kind = _block_kind(block)
        h = L.apply_norm(cfg, block["norm"], x)
        if kind == "mlstm" and cfg.mlstm_chunked and states is None:
            y = X.mlstm_forward_chunked(cfg, block[kind], h, shd=shd)
        else:
            fwd = X.slstm_forward if kind == "slstm" else X.mlstm_forward
            y, st = fwd(cfg, block[kind], h, return_state=True, shd=shd)
            if states is not None:
                states.append({kind: st})
        x = x + y
        mlp = block["mlp"]
        x = x + L.mlp(cfg, mlp.w, L.apply_norm(cfg, mlp.norm, x), shd)
    return x


def _embed(cfg: ModelConfig, params: Backbone, tokens: torch.Tensor,
           extra_embeds: Optional[torch.Tensor],
           shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """Embedded tokens, vlm's patch embeddings prepended (B, P + S, d)."""
    x = L.embed(cfg, params.embed, tokens, shd)
    if cfg.family == "vlm" and extra_embeds is not None:
        x = torch.cat([_on_batch(extra_embeds, x, shd).to(x.dtype), x], dim=1)
    return x


def _on_batch(t: torch.Tensor, like: torch.Tensor, shd: ShardingConfig) -> torch.Tensor:
    """An input ``t`` (B, ...) on ``like``'s mesh with its batch over the
    data axes (a plain ``t`` is the same on every rank: each keeps its
    rows); as it is without a mesh."""
    if not L.is_dtensor(like):
        return t
    return L.shard(L.replicate_like(t, like), shd, L.dp(shd), *(None,) * (t.dim() - 1))


def _encode(cfg: ModelConfig, params: Backbone, frames: Optional[torch.Tensor],
            freqs: torch.Tensor, shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """Whisper's encoder over frame embeddings (B, encoder_seq, d) → the
    normed encoder output (B, encoder_seq, d)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family takes its frame embeddings "
                         f"(B, {cfg.encoder_seq}, {cfg.d_model}) as extra_embeds")
    enc = _on_batch(frames, params.enc_pos, shd).to(L.param_dtype(cfg)) + params.enc_pos[None]
    b, se, _ = enc.shape
    enc = _run_units(cfg, params.enc_units, ENCODER_SUB, enc, _positions(b, se, enc),
                     freqs, shd=shd)
    return L.apply_norm(cfg, params.enc_norm, enc)


def forward(cfg: ModelConfig, params: Backbone, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """Full-sequence logits (B, S_total, V); S_total = P + S with vlm's
    ``extra_embeds`` (B, P, d); S for audio, whose ``extra_embeds`` are
    the encoder's frames (B, encoder_seq, d).  On a mesh the parameters
    and tokens are DTensors and so are the logits."""
    sub, _ = unit_structure(cfg)
    x = _embed(cfg, params, tokens, extra_embeds, shd)
    if cfg.family == "ssm":
        x = _run_blocks(cfg, params, x, shd=shd)
    else:
        freqs = L.replicate_like(L.rope_freqs(cfg, tokens.device), x)
        enc = (_encode(cfg, params, extra_embeds, freqs, shd) if cfg.family == "audio"
               else None)
        b, s, _ = x.shape
        x = _run_units(cfg, _units(cfg, params), sub, x, _positions(b, s, x), freqs,
                       enc, shd=shd)
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x, shd)


def _capture_kv_states(cfg: ModelConfig, params: Backbone, x: torch.Tensor,
                       freqs: torch.Tensor, enc: Optional[torch.Tensor] = None,
                       shd: ShardingConfig = NO_SHARDING):
    """One pass of the unit stack over embeddings ``x`` → (final hidden
    state, {"k", "v"}: K and V of every attention layer, each stacked
    (n_attn, B, S, KV, hd); for the hybrid family "ssm", each unit's final
    SSM state stacked (n_units, B, H, N, P); for the audio family
    "cross_k" and "cross_v", each decoder layer's cross-attention K/V over
    ``enc`` stacked (L, B, S_enc, KV, hd))."""
    b, s, _ = x.shape
    sub, _ = unit_structure(cfg)
    cap = {"k": [], "v": [], "ssm": [], "cross_k": [], "cross_v": []}
    x = _run_units(cfg, _units(cfg, params), sub, x, _positions(b, s, x), freqs, enc,
                   cap, shd)
    return x, {key: torch.stack(t) for key, t in cap.items() if t}


# ===========================================================================
# Serving: KV/state caches, prefill, decode_step (the paper's actor act())
# ===========================================================================


def _cache_kv_spec(cfg: ModelConfig, shd: ShardingConfig) -> tuple:
    """Sharding for (U, B, S, KV, hd): batch→data; heads→model when the
    head count divides evenly, else sequence→model (flash-decoding
    style)."""
    if not shd.enabled:
        return ()
    mode = cfg.cache_shard
    if mode == "auto":
        mode = "heads" if cfg.num_kv_heads % 16 == 0 else "seq"
    if mode == "heads":
        return canonical((None, shd.fsdp, None, shd.tp, None))
    return canonical((None, shd.fsdp, shd.tp, None, None))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, shd: ShardingConfig = NO_SHARDING, device_mesh=None) -> Cache:
    """{"pos": (batch,) int64, "k"/"v": (n_attn, batch, max_len, KV, hd)};
    a hybrid model's also "ssm" (n_units, batch, H, N, P) f32; an audio
    model's also "cross_k"/"cross_v" (L, batch, encoder_seq, KV, hd); an
    ssm model's "pos" and "blocks", one {"mlstm" | "slstm": state} a
    block.  With ``shd`` and a ``device_mesh`` every leaf is this rank's
    piece under ``launch/specs.py::cache_specs`` (K/V by ``_cache_kv_spec``,
    the recurrent states over the data axes on their batch dimension,
    ``pos`` replicated), a DTensor, and no rank makes a whole leaf."""
    sub, n_units = unit_structure(cfg)
    mesh = device_mesh if shd.enabled else None
    dp = L.dp(shd)

    def full(shape, value, dt, spec=()):
        return sharding_full(shape, value, dt, spec, mesh, device)

    cache: Cache = {"pos": full((batch,), 0, torch.int64)}
    if cfg.family == "ssm":
        def state(shape, value, dt):
            return full(shape, value, dt, (dp,) + (None,) * (len(shape) - 1))

        cache["blocks"] = [{"slstm": X.slstm_decode_init(cfg, batch, device, state)}
                           if i in cfg.slstm_at else
                           {"mlstm": X.mlstm_decode_init(cfg, batch, device, state)}
                           for i in range(cfg.num_layers)]
        return cache
    n_attn = n_units * sum(1 for k in sub if k in ("attn", "hybrid"))
    dt = dtype or L.param_dtype(cfg)
    kv_spec = _cache_kv_spec(cfg, shd)
    shape = (n_attn, batch, max_len, cfg.num_kv_heads, cfg.hd)
    cache["k"] = full(shape, 0.0, dt, kv_spec)
    cache["v"] = full(shape, 0.0, dt, kv_spec)
    if cfg.family == "hybrid":
        h, pd = M.mamba_heads(cfg)
        cache["ssm"] = full((n_units, batch, h, cfg.ssm_state, pd), 0.0, torch.float32,
                            (None, dp, None, None, None))
    if cfg.family == "audio":
        shape = (n_units, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.hd)
        cache["cross_k"] = full(shape, 0.0, dt, kv_spec)
        cache["cross_v"] = full(shape, 0.0, dt, kv_spec)
    return cache


def write_seq_prefix(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, :, :s] = src`` for a cache leaf (U, B, S, ...) and ``src``
    (U, B, s, ...).  On a mesh each rank writes only the positions of its
    own segment of ``dst``: ``src`` is placed as ``dst`` is, its sequence
    whole (where ``dst`` splits the heads ``src`` does too, and nothing
    moves; where ``dst`` splits the sequence, ``src``'s heads are gathered
    whole where the model axis split them, replicated K/V need nothing)."""
    s = src.shape[2]
    if not L.is_dtensor(dst):
        dst[:, :, :s] = src.to(dst.dtype)
        return
    from torch.distributed.tensor import Replicate

    want = [Replicate() if p.is_shard(2) else p for p in dst.placements]
    src = L.local(L.with_placements(src, dst, want)).to(dst.dtype)
    out, lo = L.local(dst), L.local_offset(dst, 2)
    hi = min(lo + out.shape[2], s)
    if hi > lo:
        out[:, :, :hi - lo] = src[:, :, lo:hi]


def write_slot(dst: torch.Tensor, slot: int, src: torch.Tensor, dim: int = 1) -> None:
    """``dst.select(dim, slot)[...] = src.select(dim, 0)``: a batch-1 leaf
    written into row ``slot`` of a batched one.  On a mesh only the rank
    that holds the row writes it, from its own piece of ``src`` (placed
    as ``dst``, its batch whole: a batch-1 leaf is replicated over the
    data axes already)."""
    if not L.is_dtensor(dst):
        dst.select(dim, slot).copy_(src.select(dim, 0))
        return
    from torch.distributed.tensor import Replicate

    want = [Replicate() if p.is_shard(dim) else p for p in dst.placements]
    src = L.local(L.with_placements(src, dst, want))
    out, lo = L.local(dst), L.local_offset(dst, dim)
    if lo <= slot < lo + out.shape[dim]:
        out.select(dim, slot - lo).copy_(src.select(dim, 0))


def _decode_mask(cfg: ModelConfig, k_pos: torch.Tensor, pos: torch.Tensor,
                 is_global: bool) -> torch.Tensor:
    """(B, S_cache) validity of cached entries for each row's query at
    ``pos`` (B,)."""
    return L._attn_mask(cfg, pos, k_pos, is_global)


def _attn_decode(cfg: ModelConfig, p: L.Attention, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                 freqs: torch.Tensor, is_global: bool,
                 write_mask: Optional[torch.Tensor] = None,
                 use_rope: bool = True, shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """x: (B, 1, d); k_cache/v_cache: (B, S, KV, hd), written in place at
    each row's ``pos`` (rows where ``write_mask`` is False keep their
    entry).  Returns the attention output (B, 1, d).  The cache is
    written by ``_write_token`` and read by ``_attend_pieces``, each on
    this rank's pieces on a mesh."""
    h, hd = cfg.num_heads, cfg.hd
    b, s_cache = x.shape[0], k_cache.shape[1]
    # the cache stores post-RoPE keys (Whisper's decoder: unrotated)
    q, k, v = L.qkv(cfg, p, x, pos[:, None], freqs, use_rope=use_rope, shd=shd)
    _write_token(k_cache, k, pos, write_mask)
    _write_token(v_cache, v, pos, write_mask)
    mask = _decode_mask(cfg, torch.arange(s_cache, device=L.local(pos).device), pos, is_global)
    out = _attend_pieces(cfg, q, k_cache, v_cache, mask)
    return L.linear(out.reshape(b, 1, h * hd), p.wo, shd=shd)


def _seq_split_dims(cache: torch.Tensor) -> List[int]:
    """The mesh dimensions of more than one rank that split a (B, S, KV,
    hd) cache's sequence."""
    return [m for m, p in enumerate(cache.placements)
            if p.is_shard(1) and cache.device_mesh.size(m) > 1]


def _write_token(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 write_mask: Optional[torch.Tensor]) -> None:
    """A cache (B, S, KV, hd) ← ``new`` (B, 1, KV, hd) at each row's
    ``pos`` (clamped, as dynamic_update_slice clamps), in place, on the
    rows of ``write_mask`` only.  On a mesh each rank writes the rows of
    its batch piece whose position falls in its sequence segment (``new``
    placed as the cache, its one position whole: where the cache splits
    the heads so does ``new``; where it splits the sequence, ``new``'s
    heads are gathered whole, one token's K or V)."""
    if L.is_dtensor(cache):
        from torch.distributed.tensor import Replicate

        want = [Replicate() if p.is_shard(1) else p for p in cache.placements]
        new = L.local(L.with_placements(new, cache, want))
    new = new[:, 0].to(cache.dtype)
    out = L.local(cache)
    b0, s0 = L.local_offset(cache, 0), L.local_offset(cache, 1)
    nb, ns = out.shape[:2]
    at = L.local(pos)[b0:b0 + nb].clamp(0, cache.shape[1] - 1) - s0
    ok = (at >= 0) & (at < ns)
    if write_mask is not None:
        ok &= L.local(write_mask)[b0:b0 + nb]
    rows, at = torch.arange(nb, device=out.device), at.clamp(0, ns - 1)
    out[rows, at] = torch.where(ok[:, None, None], new, out[rows, at])


def _attend_pieces(cfg: ModelConfig, q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Decode attention of q (B, 1, H, hd) over a cache (B, S, KV, hd),
    masked by ``mask`` (B, S).  On a mesh it runs on each rank's pieces: q
    placed as the cache (its heads split where the cache's KV heads are,
    whole where they are whole, its one position whole), the scores of the
    rank's own segment.  Where the cache's sequence is split over the mesh
    (flash-decoding) the row softmax is put together by three all-reduces
    over the splitting axes (the row max, the sum of exponentials, the
    weighted values), the log-sum-exp combine that GSPMD inserts for the
    reference; else it is the unsharded op.  Returns (B, 1, KV, q_per_kv,
    hd), on a mesh a DTensor placed as q."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate

    kc, vc = L.local(k_cache), L.local(v_cache)
    nb, ns, kvl, hd = kc.shape
    b0, s0 = L.local_offset(k_cache, 0), L.local_offset(k_cache, 1)
    mesh, want, dims = L.mesh_of(k_cache), None, []
    if mesh is not None:
        want = [Replicate() if p.is_shard(1) else p for p in k_cache.placements]
        q, dims = L.local(L.with_placements(q, k_cache, want)), _seq_split_dims(k_cache)

    def placed(out):
        return out if mesh is None else DTensor.from_local(out, mesh, want, run_check=False)

    qg = q.reshape(nb, 1, kvl, -1, hd)
    scores = torch.einsum("bsgqh,btgh->bgqst", qg, kc).float()
    scores = scores / math.sqrt(hd)
    m = L.local(mask)[b0:b0 + nb, s0:s0 + ns]
    scores = scores.masked_fill(~m[:, None, None, None, :], L.NEG)
    if not dims:
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return placed(torch.einsum("bgqst,btgh->bsgqh", w, vc))

    def reduce(t, op):
        for d in dims:
            t = funcol.all_reduce(t, op, (mesh, d))
        return funcol.wait_tensor(t)

    row_max = reduce(scores.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(scores - row_max)
    total = reduce(e.sum(dim=-1, keepdim=True), "sum")
    w = (e / total).to(q.dtype)
    return placed(reduce(torch.einsum("bgqst,btgh->bsgqh", w, vc), "sum"))


def _write_state(old: torch.Tensor, new: torch.Tensor,
                 write_mask: Optional[torch.Tensor]) -> None:
    """``old`` (B, ...) ← ``new`` in place, on the rows of ``write_mask``
    only (every row without one)."""
    if write_mask is not None:
        new = torch.where(write_mask.reshape(-1, *(1,) * (new.dim() - 1)), new, old)
    _assign(old, new)


def _decode_blocks(cfg: ModelConfig, params: Backbone, cache: Cache, x: torch.Tensor,
                   write_mask: Optional[torch.Tensor],
                   shd: ShardingConfig = NO_SHARDING) -> torch.Tensor:
    """The xLSTM blocks' decode step, each block's state updated in place."""
    for block, state in zip(params.blocks, cache["blocks"]):
        x = _carry(x, shd)
        kind = _block_kind(block)
        h = L.apply_norm(cfg, block["norm"], x)
        step = X.slstm_decode_step if kind == "slstm" else X.mlstm_decode_step
        y, new = step(cfg, block[kind], h, state[kind], shd=shd)
        for old_t, new_t in zip(state[kind], new):
            _write_state(old_t, new_t, write_mask)
        x = x + y
        mlp = block["mlp"]
        x = x + L.mlp(cfg, mlp.w, L.apply_norm(cfg, mlp.norm, x), shd)
    return x


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Backbone, cache: Cache,
                tokens: torch.Tensor, write_mask: Optional[torch.Tensor] = None,
                shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step: logits (B, 1, V) for the next token, and
    the cache, updated in place (``pos`` advanced by one on every row, or
    on the rows of ``write_mask`` only; the other rows' K/V entries and
    recurrent states stay as they were).  Whisper's cross-attention reads
    the cached cross K/V, which no step writes."""
    sub, n_units = unit_structure(cfg)
    pos = cache["pos"]
    x = L.embed(cfg, params.embed, tokens, shd)
    if write_mask is not None:
        write_mask = _replicated(write_mask, x)
    if cfg.family == "ssm":
        x = _decode_blocks(cfg, params, cache, x, write_mask, shd)
    else:
        flags = _global_flags(cfg, n_units, sub)
        freqs = L.replicate_like(L.rope_freqs(cfg, L.local(x).device), x)
        layer = 0
        for u, (unit, flag_row) in enumerate(zip(_units(cfg, params), flags)):
            x = _carry(x, shd)
            fi = 0
            for kind in sub:
                p = unit[kind]
                hdn = L.apply_norm(cfg, p.norm, x)
                if kind in ("attn", "hybrid"):
                    y = _attn_decode(cfg, p.w if kind == "attn" else p.attn, hdn,
                                     cache["k"][layer], cache["v"][layer], pos, freqs,
                                     flag_row[fi], write_mask,
                                     use_rope=cfg.family != "audio", shd=shd)
                    fi += 1
                    layer += 1
                    if kind == "hybrid":
                        ys, new_ssm = M.mamba_decode_step(cfg, p.ssm, hdn, cache["ssm"][u],
                                                          shd=shd)
                        _write_state(cache["ssm"][u], new_ssm, write_mask)
                        y = 0.5 * (L.apply_norm(cfg, p.norm_attn, y)
                                   + L.apply_norm(cfg, p.norm_ssm, ys))
                    x = x + y
                elif kind == "cross":
                    x = x + L.mha(cfg, p.w, hdn, pos[:, None], freqs, True, causal=False,
                                  kv_override=(cache["cross_k"][u], cache["cross_v"][u]),
                                  shd=shd)
                elif kind == "moe":
                    x = x + MOE.moe(cfg, p.w, hdn, drop=False, shd=shd)[0]
                else:
                    x = x + L.mlp(cfg, p.w, hdn, shd)
    step = torch.ones_like(pos) if write_mask is None else write_mask.to(pos.dtype)
    cache["pos"] = pos + step
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x, shd), cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Backbone, tokens: torch.Tensor,
            max_len: int, extra_embeds: Optional[torch.Tensor] = None,
            shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, Cache]:
    """Process full prompts (B, S), vlm's ``extra_embeds`` (B, P, d)
    before them: logits (B, P + S, V) and a primed cache with ``pos`` =
    P + S on every row (and each SSM or xLSTM state after the prompt).
    For audio ``extra_embeds`` are the frames (B, encoder_seq, d): the
    logits are (B, S, V), the cache holds each decoder layer's cross K/V,
    and ``pos`` = S."""
    b = tokens.shape[0]
    mesh = L.mesh_of(params.embed.tok) if shd.enabled else None
    cache = init_cache(cfg, b, max_len, device=L.local(tokens).device, shd=shd,
                       device_mesh=mesh)
    x = _embed(cfg, params, tokens, extra_embeds, shd)
    s = x.shape[1]
    if cfg.family == "ssm":
        states = []
        x = _run_blocks(cfg, params, x, states, shd)
        for old, new in zip(cache["blocks"], states):
            for kind, state in new.items():
                for dst, src in zip(old[kind], state):
                    _assign(dst, src)
    else:
        freqs = L.replicate_like(L.rope_freqs(cfg, L.local(x).device), x)
        enc = (_encode(cfg, params, extra_embeds, freqs, shd) if cfg.family == "audio"
               else None)
        x, cap = _capture_kv_states(cfg, params, x, freqs, enc, shd)
        write_seq_prefix(cache["k"], cap["k"])
        write_seq_prefix(cache["v"], cap["v"])
        for key in ("ssm", "cross_k", "cross_v"):
            if key in cap:
                _assign(cache[key], cap[key])
    L.local(cache["pos"]).fill_(s)
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x, shd), cache


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; on a mesh ``src`` is placed as ``dst`` first and
    each rank copies its own piece."""
    if L.is_dtensor(dst):
        src = L.with_placements(src, dst, dst.placements)
    L.local(dst).copy_(L.local(src))


def _replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on ``like``'s mesh where ``like`` is a DTensor."""
    if not L.is_dtensor(like):
        return t
    from torch.distributed.tensor import Replicate

    return L.with_placements(t, like, [Replicate()] * like.device_mesh.ndim)


def flash_launches_per_prefill(cfg: ModelConfig) -> int:
    """Flash-kernel launches of one ``prefill`` with ``attn_impl="flash"``
    at a length that is a multiple of 128: one per attention layer (a
    hybrid layer's included), one pass; none for the ssm family.  Whisper's
    cross-attention never takes flash, and its encoder layers do when
    ``encoder_seq`` is a multiple of 128 (1,500 is not)."""
    sub, n_units = unit_structure(cfg)
    n = n_units * sum(1 for k in sub if k in ("attn", "hybrid"))
    if cfg.family == "audio" and cfg.encoder_seq % 128 == 0:
        n += cfg.encoder_layers
    return n
