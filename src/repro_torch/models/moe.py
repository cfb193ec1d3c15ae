"""Mixture-of-Experts layer — port of ``repro.models.moe``: top-k routing
with capacity and rank dispatch.

Dense, sort-free dispatch, as the reference's:

  1. f32 router logits, softmax, top-k expert ids (T, k) and the gate
     weights renormalized over the k;
  2. the rank of each token within its expert by a (T, E) cumsum, one
     pass per top-k slot;
  3. tokens over the capacity ``C = max(8, ceil128(cf·T·k/E))`` are dropped
     (GShard semantics, counted in ``dropped_frac``);
  4. scatter-add into an (E, C, d) buffer → the batched expert GLU
     (``torch.bmm``; the reference computes it outside any Pallas kernel,
     so no hand-written kernel stands behind it) → gather back, weighted
     in f32;
  5. the shared expert (Llama-4), and a cast to the input's dtype.

Capacity is taken over the T tokens of one call, so routing depends on
the batch.  The reference's serve engine decodes a batch of 1 per slot,
whose capacity (8) no single token can exceed; the port decodes all slots
in one call, so ``decode_step`` routes with ``drop=False``: the capacity
is T, no token is dropped, and each row gets what the reference's
per-slot call gives it (free slots take no capacity from busy ones).

Sharding, as the reference's (``shd``): with ``cfg.moe_local_dispatch``,
an enabled ``shd`` with data axes, and T a multiple of ``shd.dp_extent``,
the T tokens split into ``ds = dp_extent`` consecutive shards, each with
its own ranks and its own capacity over T / ds tokens, so a different set
of tokens can drop (per-shard GShard semantics).  The buffer is (E, ds·C,
d), shard i's slots at [i·C, (i+1)·C): the expert GLU is one ``bmm`` over
every shard's rows, and with ds = 1 the call is the unsharded one.  This
holds whether or not a mesh is installed: a one-process run under
``launch/train.py --mesh 16x16`` routes so, as the reference's does.
``moe_ff_tp_fallback`` picks the expert axis of the constraints: the
experts over the model axis (EP) when they divide ``shd.tp_extent`` or the
fallback is off, else d_ff over it.  On DTensors (a mesh of ranks) the
dispatch's ops (the rank ``cumsum`` over tokens, the scatter-add into the
buffer, ``topk``) have no sharding rules, so ``moe`` replicates its input
and the expert weights explicitly (where the reference's GSPMD gathers)
and computes the layer on every rank.

Two measurement aids: ``recording()`` collects each call's metrics and
expert ids, which the backbone discards as the reference's ``_apply_sub``
does; ``routed_as(records)`` makes each call route to the experts a
recorded run chose, so that two runs that differ only in rounding (bf16
and f32, flash and naive attention) compare without the discrete flips of
near-tied routes.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig

_RECORD: Optional[List[Dict[str, torch.Tensor]]] = None
_ROUTES: Optional[Iterator[torch.Tensor]] = None


class MoE(nn.Module):
    """``moe_init``: ``router`` (d, E) f32, ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the config's dtype (the reference's layout),
    and with ``num_shared_experts`` a ``shared`` GLU of width
    d_ff · num_shared_experts."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt, e, d, f = L.param_dtype(cfg), cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty((d, e), dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty((e, d, f), dtype=dt, device=device))
        self.w_up = nn.Parameter(torch.empty((e, d, f), dtype=dt, device=device))
        self.w_down = nn.Parameter(torch.empty((e, f, d), dtype=dt, device=device))
        self.shared = (L.GLU(cfg, d_ff=cfg.d_ff * cfg.num_shared_experts, device=device)
                       if cfg.num_shared_experts else None)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's distributions: router N(0, 1/d), w_gate and w_up
        N(0, 1/d), w_down N(0, 1/f), drawn one expert at a time, so the f32
        temporary is one expert's matrix (168 MB at Llama-4's 5,120 × 8,192),
        not the whole (E, d, f) stack."""
        d = self.router.shape[0]
        z = torch.randn(self.router.shape, generator=gen, device=self.router.device)
        self.router.copy_(z.mul_(1.0 / math.sqrt(d)))
        for w in (self.w_gate, self.w_up, self.w_down):
            scale = 1.0 / math.sqrt(w.shape[1])
            for i in range(w.shape[0]):
                z = torch.randn(w.shape[1:], generator=gen, device=w.device,
                                dtype=torch.float32)
                w[i].copy_(z.mul_(scale))
        if self.shared is not None:
            self.shared.reset_parameters(gen)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """The reference's expert capacity for ``tokens`` tokens in one call,
    lane-aligned to 128 and at least 8."""
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.num_experts)
    return max(8, ((c + 127) // 128) * 128)


def route(cfg: ModelConfig, p: MoE, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) → (f32 router probabilities (T, E), renormalized gate
    weights (T, k), expert ids (T, k)).  Inside ``routed_as`` the ids are
    the recorded ones and the gate weights this router's at them."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    if _ROUTES is None:
        gate_w, expert_id = torch.topk(probs, cfg.experts_per_token, dim=-1)
    else:
        expert_id = next(_ROUTES, None)
        if expert_id is None:
            raise ValueError("routed_as: more moe calls than recorded routes")
        expert_id = expert_id.to(xt.device)
        if expert_id.shape != (xt.shape[0], cfg.experts_per_token):
            raise ValueError(f"routed_as: a recorded route of {tuple(expert_id.shape)} for "
                             f"{xt.shape[0]} tokens at top-{cfg.experts_per_token}")
        gate_w = probs.gather(1, expert_id)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, expert_id


def local_shards(cfg: ModelConfig, shd: ShardingConfig, tokens: int) -> int:
    """The reference's ``ds``: ``shd.dp_extent`` dispatch shards with
    ``moe_local_dispatch`` on an enabled ``shd`` with data axes when it
    divides the tokens, else 1."""
    if cfg.moe_local_dispatch and shd.enabled and shd.fsdp and tokens % shd.dp_extent == 0:
        return shd.dp_extent
    return 1


def moe(cfg: ModelConfig, p: MoE, x: torch.Tensor, drop: bool = True,
        shd: ShardingConfig = NO_SHARDING) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) → (y (B, S, d) in x's dtype, {"aux_loss",
    "dropped_frac"}).  With ``drop=False`` the capacity is a shard's token
    count, so every token reaches its k experts (the batched decode)."""
    if L.is_dtensor(x):
        return _moe_replicated(cfg, p, x, drop, shd)
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.experts_per_token
    xt = L.shard(x.reshape(t, d), shd, L.dp(shd), None)
    probs, gate_w, expert_id = route(cfg, p, xt)

    # load-balancing auxiliary loss (Switch/GShard), from the first choice
    me = probs.mean(0)
    ce = F.one_hot(expert_id[:, 0], e).float().mean(0)
    aux_loss = e * torch.sum(me * ce)

    # expert-dim sharding when E divides the model axis (EP), else d_ff over
    # the model axis (dense-style TP inside each expert)
    ep = e % max(1, shd.tp_extent) == 0 or not cfg.moe_ff_tp_fallback
    e_ax, f_ax = (shd.tp, None) if ep else (None, shd.tp)
    ds = local_shards(cfg, shd, t)
    tl = t // ds
    c = capacity(cfg, tl) if drop else tl
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    keeps = []
    for slot in range(k):
        eid = expert_id[:, slot]                          # (T,)
        onehot = F.one_hot(eid, e).reshape(ds, tl, e)     # (DS, Tl, E)
        rank = onehot.cumsum(1) - onehot                  # rank within the shard's expert
        pos = rank.gather(2, eid.reshape(ds, tl, 1))[..., 0]
        keep = (pos < c).reshape(t)
        keeps.append(keep)
        dropped = dropped + (~keep).sum().float()
        safe_pos = torch.where(pos < c, pos, c - 1)
        if ds > 1:                                        # shard i's slots from i·C
            safe_pos = safe_pos + (torch.arange(ds, device=x.device) * c)[:, None]
        safe_pos = safe_pos.reshape(t)
        contrib = torch.where(keep[:, None], xt, torch.zeros_like(xt))
        buf = torch.zeros((e, ds * c, d), dtype=x.dtype, device=x.device)
        buf = buf.index_put((eid, safe_pos), contrib, accumulate=True)
        buf = L.shard(buf, shd, e_ax, L.dp(shd) if ds > 1 else None, None)
        h = L._act(cfg, torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
        h = L.shard(h, shd, e_ax, L.dp(shd) if ds > 1 else None, f_ax)
        y_e = torch.bmm(h, p.w_down)                      # (E, DS·C, d)
        y_t = y_e[eid, safe_pos]                          # (T, d)
        out = out + torch.where(keep[:, None], y_t.float() * gate_w[:, slot:slot + 1],
                                torch.zeros_like(out))

    if p.shared is not None:
        out = out + L.mlp(cfg, p.shared, x, shd).reshape(t, d).float()

    metrics = {"aux_loss": aux_loss, "dropped_frac": dropped / (t * k)}
    if _RECORD is not None:
        _RECORD.append(dict(metrics, expert_id=expert_id.detach(), probs=probs.detach(),
                            keep=torch.stack(keeps, dim=1), tokens=t, capacity=c,
                            shards=ds))
    return out.reshape(b, s, d).to(x.dtype), metrics


def _moe_replicated(cfg: ModelConfig, p: MoE, x: torch.Tensor, drop: bool,
                    shd: ShardingConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe`` on DTensors: the input and every weight replicated
    (all-gathered) and the layer computed on each rank's full copy through
    ``local_map``; the output and metrics replicated.  Each rank's weight
    gradients are the full ones, so they stay replicated too."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    names = [n for n, _ in p.named_parameters()]

    def local(xl, *weights):
        return _moe_with(cfg, p, dict(zip(names, weights)), xl, drop, shd)

    args = [t.redistribute(mesh, rep) for t in (x, *p.parameters())]
    y, aux, frac = local_map(local, out_placements=(rep, rep, rep),
                             in_placements=(rep,) * len(args), device_mesh=mesh)(*args)
    return y, {"aux_loss": aux, "dropped_frac": frac}


def _moe_with(cfg, p, weights, x, drop, shd):
    """``moe`` of plain tensors with ``p``'s parameters replaced by
    ``weights`` ({name: tensor}) → (y, aux_loss, dropped_frac)."""
    local = SimpleNamespace(**{n: weights[n] for n in ("router", "w_gate", "w_up", "w_down")},
                            shared=None)
    if p.shared is not None:
        local.shared = SimpleNamespace(**{n: weights[f"shared.{n}"]
                                          for n in ("w_gate", "w_up", "w_down")})
    y, m = moe(cfg, local, x, drop, shd)
    return y, m["aux_loss"], m["dropped_frac"]


@contextlib.contextmanager
def recording() -> Iterator[List[Dict[str, torch.Tensor]]]:
    """Within the block, every ``moe`` call appends {"aux_loss",
    "dropped_frac", "expert_id" (T, k), "probs" (T, E) f32, "keep" (T, k)
    bool, "tokens", "capacity"} to the yielded list, in call order."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


@contextlib.contextmanager
def routed_as(records: List[Dict[str, torch.Tensor]]) -> Iterator[None]:
    """Within the block, the i-th ``moe`` call routes its tokens to
    ``records[i]["expert_id"]`` (a ``recording()`` of the same tokens), its
    gate weights taken from its own router at those experts; ranks, drops
    and the expert GLUs follow as usual.  Raises if the calls outnumber the
    records or a record's shape differs."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, iter([r["expert_id"] for r in records])
    try:
        yield
    finally:
        _ROUTES = prev


def dropped_if_capped(cfg: ModelConfig, expert_id: torch.Tensor) -> int:
    """The tokens that the capacity of one call over these T tokens would
    drop, summed over the k slots: for a decode step, what a
    capacity-limited batched step would lose."""
    t, k = expert_id.shape
    c = capacity(cfg, t)
    counts = torch.stack([torch.bincount(expert_id[:, j], minlength=cfg.num_experts)
                          for j in range(k)])
    return int((counts - c).clamp_min(0).sum())
