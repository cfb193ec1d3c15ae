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
  * no sharding arguments: one card has no mesh.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
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


def _td_loss(cfg: ModelConfig, tcfg: TokenDQNConfig, params: backbone.Backbone,
             target: backbone.Backbone, mb: Dict[str, torch.Tensor]
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
    logits = backbone.forward(cfg, params, tokens, extra)         # (b, P + S, V)
    off = logits.shape[1] - tokens.shape[1]             # vlm: patch offset; audio: 0
    q = logits[:, off:].float()
    del logits
    q_sa = torch.gather(q, -1, actions[..., None])[..., 0]
    with torch.no_grad():
        qt = backbone.forward(cfg, target, tokens, extra)[:, off:].float()
        if tcfg.double_q:   # DDQN: select with online, evaluate with target
            sel = torch.argmax(q, dim=-1)
            v_next_all = torch.gather(qt, -1, sel[..., None])[..., 0]
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


def train_step(cfg: ModelConfig, tcfg: TokenDQNConfig, state: TrainState,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor], torch.Tensor]:
    """One learner update (paper Alg. 1 lines 12-18, token MDP), in place.

    Returns (state', metrics, per-sequence |TD| for the priority update).
    """
    accum = max(1, tcfg.accum)
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not a multiple of accum {accum}")
    mb_size = b // accum
    params = list(state.params.parameters())
    if accum == 1:
        loss, aux = _td_loss(cfg, tcfg, state.params, state.target, batch)
        grads = list(torch.autograd.grad(loss, params))
        loss, tds, qmean = loss.detach(), aux["seq_td"], aux["q_mean"]
    else:
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = qmean = torch.zeros((), dtype=torch.float32, device=params[0].device)
        parts = []
        for i in range(accum):
            mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            mloss, aux = _td_loss(cfg, tcfg, state.params, state.target, mb)
            torch._foreach_add_(grads, torch.autograd.grad(mloss, params))
            loss, qmean = loss + mloss.detach(), qmean + aux["q_mean"]
            parts.append(aux["seq_td"])
        torch._foreach_div_(grads, float(accum))
        loss, qmean, tds = loss / accum, qmean / accum, torch.cat(parts)
    opt, gnorm = adam.update(grads, state.opt, params, tcfg.opt)
    del grads
    adam.ema_update(state.target.parameters(), params, tcfg.target_tau)
    metrics = {"loss": loss, "grad_norm": gnorm, "q_mean": qmean}
    return TrainState(state.params, state.target, opt, state.step + 1), metrics, tds


@torch.no_grad()
def serve_step(cfg: ModelConfig, params: backbone.Backbone, cache: backbone.Cache,
               tokens: torch.Tensor, slot_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, backbone.Cache]:
    """Actor act(): one KV-cached decode step → greedy Q action (B,) and
    the cache, updated in place.

    ``slot_mask`` (B,) bool is the continuous-batching hook: a masked-out
    (free) row still rides the batched compute, but its cache, ``pos``
    included, is left as it was and its action is pinned to 0, so a
    stale slot never advances between a release and the next admission.
    """
    logits, cache = backbone.decode_step(cfg, params, cache, tokens, slot_mask)
    action = torch.argmax(logits[:, -1, :], dim=-1)
    if slot_mask is None:
        return action, cache
    return torch.where(slot_mask, action, torch.zeros_like(action)), cache
