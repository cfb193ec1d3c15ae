"""Token-MDP Q-learner over the LM backbones — port of
``repro.agents.token_dqn``: the learner's ``train_step`` and the actor's
``serve_step``.

The paper's learner (§V-B) at LM scale: Q(s, ·) = the backbone's logits;
a transition is one position of a trajectory segment (state = prefix,
action = next token, per-position reward/done).  The DQN/DDQN TD rule
applies verbatim, PER importance weights included, and per-*sequence*
mean |TD| is the new buffer priority.

Differences from the reference, for one card and eager PyTorch:
  * the online network, the target network and the Adam moments are
    updated **in place** (the returned ``TrainState`` holds the same
    tensors); the target forward runs under ``torch.no_grad()``, the
    reference's ``stop_gradient``;
  * gradient accumulation over ``accum`` microbatches is a Python loop;
    with ``accum > 1`` the gradients are summed in f32 buffers and divided
    by ``accum``, as the reference's ``gzero`` (``.grad`` accumulation
    would round to bf16 at every microbatch); with ``accum = 1`` they stay
    in the parameters' dtype, as the reference's;
  * sharding, as the reference's: ``train_step`` and ``serve_step`` take
    a ``ShardingConfig``.  On a mesh of ranks the parameters, the target
    and the moments are DTensors placed by ``state_specs``
    (``launch/sharded.py`` builds them), and the step redistributes the
    gradients to their parameters' placements before the optimizer (the
    reduce that GSPMD inserts).  Unsharded tensors take the unsharded
    path, unchanged.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import backbone
from repro_torch.models import layers as L
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig
from repro_torch.optim import adam


@dataclasses.dataclass(frozen=True)
class TokenDQNConfig:
    gamma: float = 0.99
    target_tau: float = 0.01
    double_q: bool = True
    accum: int = 1                 # gradient-accumulation microbatches
    opt: adam.AdamConfig = adam.AdamConfig(lr=3e-5)


class TrainState(NamedTuple):
    params: backbone.Backbone      # online network
    target: backbone.Backbone      # target network (no grad)
    opt: adam.AdamState
    step: torch.Tensor             # int32 scalar


def init_train_state(cfg: ModelConfig, tcfg: TokenDQNConfig, gen: torch.Generator,
                     device=None) -> TrainState:
    """Random online weights from ``gen`` (on its device), the target a
    copy of them, zero Adam moments."""
    params = backbone.init_params(cfg, gen, device)
    target = copy.deepcopy(params).requires_grad_(False)
    dev = next(params.parameters()).device
    return TrainState(params=params, target=target,
                      opt=adam.init(params.parameters(), tcfg.opt),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def state_specs(cfg: ModelConfig, shd: ShardingConfig, state: TrainState) -> TrainState:
    """Spec tree of a ``TrainState`` (ZeRO-1: the Adam moments mirror the
    parameters): ``params`` and ``target`` {name: spec}, the moments a
    list in parameter order, ``count`` and ``step`` replicated."""
    pspec = backbone.param_specs(cfg, shd, state.params)
    mspec = list(pspec.values())
    return TrainState(params=pspec, target=pspec,
                      opt=adam.AdamState(count=(), m=mspec, v=mspec), step=())


def state_spec_leaves(specs: TrainState) -> Dict[str, tuple]:
    """{name: spec} of ``state_specs``'s tree under the names of
    ``agents.base.state_tensors``."""
    names = list(specs.params)
    out = {f"params/{n}": s for n, s in specs.params.items()}
    out.update({f"target/{n}": s for n, s in specs.target.items()})
    out["opt/count"] = specs.opt.count
    out.update({f"opt/m/{n}": s for n, s in zip(names, specs.opt.m)})
    out.update({f"opt/v/{n}": s for n, s in zip(names, specs.opt.v)})
    out["step"] = specs.step
    return out


def _td_loss(cfg: ModelConfig, tcfg: TokenDQNConfig, params: backbone.Backbone,
             target: backbone.Backbone, mb: Dict[str, torch.Tensor],
             shd: ShardingConfig = NO_SHARDING
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-microbatch TD loss → (loss, aux): aux holds the per-sequence
    mean |TD| ``seq_td`` (b,), the mean Q(s, a) ``q_mean``, and the
    per-position ``td`` and ``q_sa`` (b, S), all detached.  mb:
    tokens/actions/rewards/dones (b, S), is_weights (b,), optional
    extra_embeds: vlm's patches (b, P, d), whose P positions are cut from
    the logits, or audio's frames (b, encoder_seq, d), which feed the
    encoder (the logits are the decoder's, so the offset is 0)."""
    tokens, actions = mb["tokens"].long(), mb["actions"].long()
    rewards, dones, is_w = mb["rewards"], mb["dones"], mb["is_weights"]
    extra = mb.get("extra_embeds")
    logits = backbone.forward(cfg, params, tokens, extra, shd)    # (b, P + S, V)
    off = logits.shape[1] - tokens.shape[1]             # vlm: patch offset; audio: 0
    # on a mesh the logits are vocab-sharded over the model axis; the
    # gather at the actions and the argmax over the vocabulary have no
    # sharding rule there, so q is replicated over the vocabulary first
    # (an all-gather over the model axis, where GSPMD gathers too)
    q = L.shard(logits[:, off:].float(), shd, L.dp(shd), None, None)
    del logits
    q_sa = _take(q, actions)
    with torch.no_grad():
        qt = L.shard(backbone.forward(cfg, target, tokens, extra, shd)[:, off:].float(),
                     shd, L.dp(shd), None, None)
        if tcfg.double_q:   # DDQN: select with online, evaluate with target
            sel = torch.argmax(q, dim=-1)
            v_next_all = _take(qt, sel)
        else:
            v_next_all = qt.max(dim=-1).values
        del qt
        # s' of position t is position t+1; terminal segment tail bootstraps 0
        v_next = torch.cat([v_next_all[:, 1:], torch.zeros_like(v_next_all[:, :1])], dim=1)
        tgt = rewards + tcfg.gamma * (1.0 - dones) * v_next
    td = q_sa - tgt
    loss = torch.mean(is_w[:, None] * torch.square(td))
    td, q_sa = td.detach(), q_sa.detach()
    return loss, {"seq_td": td.abs().mean(dim=1), "q_mean": q_sa.mean(), "td": td,
                  "q_sa": q_sa}


def _take(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``q[..., actions]`` (b, S) of q (b, S, V).  On a mesh each rank
    gathers its own rows (q's vocabulary whole, the actions placed as q):
    DTensor's rule for the gather replicates q over the batch, and its
    backward makes the whole batch's (b, S, V) zeros on every rank and
    reduce-scatters them, the largest collective of a train step."""
    def take(q_, a):
        return torch.gather(q_, -1, a[..., None])[..., 0]

    if not L.is_dtensor(q):
        return take(q, actions)
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(q.placements)
    return local_map(take, out_placements=list(pl), in_placements=(pl, pl),
                     in_grad_placements=(pl, pl), device_mesh=q.device_mesh)(
        q, L.with_placements(actions, q, pl))


def _pin_batch(shd: ShardingConfig, mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A microbatch's batch axis pinned to the data axes (the reference's
    constraint after its (accum, B/accum) reshape)."""
    return {k: L.shard(v, shd, L.dp(shd), *(None,) * (v.dim() - 1)) for k, v in mb.items()}


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if L.is_dtensor(x) else x


def train_step(cfg: ModelConfig, shd: ShardingConfig, tcfg: TokenDQNConfig,
               state: TrainState, batch: Dict[str, torch.Tensor]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor], torch.Tensor]:
    """One learner update (paper Alg. 1 lines 12-18, token MDP), in place.

    Returns (state', metrics, per-sequence |TD| for the priority update).
    On a mesh (DTensor parameters and batch, ``launch/sharded.py``) the
    step runs under ``implicit_replication`` (host scalars and index
    tensors are the same on every rank), each gradient is redistributed to
    its parameter's placements before Adam, and the metrics and |TD| come
    back as whole tensors.
    """
    accum = max(1, tcfg.accum)
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not a multiple of accum {accum}")
    mb_size = b // accum
    params = list(state.params.parameters())
    sharded = L.is_dtensor(params[0])
    if sharded:
        from torch.distributed.tensor.experimental import implicit_replication
        ctx = implicit_replication()
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        if accum == 1:
            loss, aux = _td_loss(cfg, tcfg, state.params, state.target, _pin_batch(shd, batch),
                                 shd)
            grads = list(torch.autograd.grad(loss, params))
            loss, tds, qmean = loss.detach(), aux["seq_td"], aux["q_mean"]
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = qmean = torch.zeros((), dtype=torch.float32, device=params[0].device)
            parts = []
            # on a mesh the batch is made whole on every rank once (as the
            # reference's (accum, B/accum) reshape moves it once), so that
            # each microbatch is a local slice, pinned to the data axes by a
            # local split: a slice of the split batch would gather it whole
            # again at every microbatch
            whole = {k: L.shard(v, shd, *(None,) * v.dim()) for k, v in batch.items()}
            for i in range(accum):
                mb = _pin_batch(shd, {k: v[i * mb_size:(i + 1) * mb_size]
                                      for k, v in whole.items()})
                mloss, aux = _td_loss(cfg, tcfg, state.params, state.target, mb, shd)
                mgrads = torch.autograd.grad(mloss, params)
                if sharded:
                    mgrads = [g.redistribute(p.device_mesh, p.placements)
                              for g, p in zip(mgrads, params)]
                torch._foreach_add_(grads, mgrads)
                loss, qmean = loss + mloss.detach(), qmean + aux["q_mean"]
                parts.append(aux["seq_td"])
            torch._foreach_div_(grads, float(accum))
            loss, qmean, tds = loss / accum, qmean / accum, torch.cat(parts)
        if sharded:
            # the gradient reduce: partial sums over the data axes and the
            # replicated leaves' partials over the model axis
            grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, params)]
        opt, gnorm = adam.update(grads, state.opt, params, tcfg.opt)
        del grads
        adam.ema_update(state.target.parameters(), params, tcfg.target_tau)
        metrics = {"loss": _full(loss), "grad_norm": _full(gnorm), "q_mean": _full(qmean)}
        tds = _full(tds)
    return TrainState(state.params, state.target, opt, state.step + 1), metrics, tds


@torch.no_grad()
def serve_step(cfg: ModelConfig, params: backbone.Backbone, cache: backbone.Cache,
               tokens: torch.Tensor, slot_mask: Optional[torch.Tensor] = None,
               shd: ShardingConfig = NO_SHARDING
               ) -> Tuple[torch.Tensor, backbone.Cache]:
    """Actor act(): one KV-cached decode step → greedy Q action (B,) and
    the cache, updated in place.

    ``slot_mask`` (B,) bool is the continuous-batching hook: a masked-out
    (free) row still rides the batched compute, but its cache, ``pos``
    included, is left as it was and its action is pinned to 0, so a
    stale slot never advances between a release and the next admission.
    """
    logits, cache = backbone.decode_step(cfg, params, cache, tokens, slot_mask, shd)
    # on a mesh the logits are vocab-sharded over the model axis, and the
    # argmax over the vocabulary has no sharding rule there: replicated
    # over the vocabulary first, as the TD loss's, and the actions come
    # back whole, the same on every rank
    action = _full(torch.argmax(L.shard(logits[:, -1, :], shd, L.dp(shd), None), dim=-1))
    if slot_mask is None:
        return action, cache
    return torch.where(L.local(slot_mask), action, torch.zeros_like(action)), cache
