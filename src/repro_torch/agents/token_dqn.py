"""Token-MDP Q-learner over the LM backbones — port of
``repro.agents.token_dqn``, the actor's ``serve_step`` only.

Q(s, ·) is the backbone's logits, so the greedy action is their argmax.
``train_step`` (the learner) comes with the token-DQN training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig


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
