"""The repository's own Adam/AdamW — port of ``repro.optim.adam``.

Not ``torch.optim.Adam`` with ``clip_grad_norm_``: the reference clips
by ``min(1, grad_clip / max(gnorm, 1e-12))`` where torch divides by
``norm + 1e-6``, and it takes the bias correction from an int32 step
``count`` in f32.  Parameters are a list of f32 tensors (an
``nn.Module``'s ``parameters()`` in order) and are updated **in place**
with multi-tensor (``_foreach``) ops, a handful of launches per step
instead of a dozen per parameter.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0          # global-norm clip; 0 disables


class AdamState(NamedTuple):
    count: torch.Tensor        # int32 scalar
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def init(params: Sequence[torch.Tensor], cfg: AdamConfig) -> AdamState:
    params = list(params)
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        m=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        v=[torch.zeros_like(p, dtype=torch.float32) for p in params])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in tensors]).sum())


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state: AdamState,
           params: Sequence[torch.Tensor], cfg: AdamConfig
           ) -> Tuple[AdamState, torch.Tensor]:
    """One Adam step, in place on ``params`` and the moments.  Returns
    (new state, pre-clip grad norm)."""
    grads, params = list(grads), list(params)
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = torch._foreach_mul(grads, scale)
    count = state.count + 1
    countf = count.float()
    b1c = 1.0 - cfg.b1 ** countf
    b2c = 1.0 - cfg.b2 ** countf
    m, v = state.m, state.v
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, grads, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, grads, grads, value=1 - cfg.b2)
    # step = lr · (m / b1c) / (sqrt(v / b2c) + eps)
    denom = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    step = torch._foreach_div(m, b1c)
    torch._foreach_mul_(step, cfg.lr)
    torch._foreach_div_(step, denom)
    if cfg.weight_decay:
        torch._foreach_add_(step, params, alpha=cfg.lr * cfg.weight_decay)
    torch._foreach_sub_(params, step)
    return AdamState(count, m, v), gnorm


@torch.no_grad()
def ema_update(target: Sequence[torch.Tensor], online: Sequence[torch.Tensor],
               tau: float) -> None:
    """Polyak target update ``t ← t·(1-τ) + o·τ``, in place on ``target``."""
    target = list(target)
    torch._foreach_mul_(target, 1 - tau)
    torch._foreach_add_(target, list(online), alpha=tau)
