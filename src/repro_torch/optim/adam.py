"""The repository's own Adam/AdamW — port of ``repro.optim.adam``.

Not ``torch.optim.Adam`` with ``clip_grad_norm_``: the reference clips
by ``min(1, grad_clip / max(gnorm, 1e-12))`` where torch divides by
``norm + 1e-6``, and it takes the bias correction from an int32 step
``count`` in f32.  Parameters are a list of tensors (an ``nn.Module``'s
``parameters()`` in order), f32 or bf16, and are updated **in place**
with multi-tensor (``_foreach``) ops, a handful of launches per step
instead of a dozen per parameter.  The ops run on groups of at most
``GROUP_ELEMS`` elements, so that their f32 temporaries stay small
beside a model of billions of parameters (CartPole's MLP is one group).

With bf16 parameters the arithmetic stays in f32, as the reference's
``astype`` chain: the clipped gradient is f32 (the reference's bf16 × f32
scale promotes), the moments are f32, and ``_foreach_sub_`` of the f32
step from a bf16 parameter computes in f32 and rounds once.  The EMA
target ``t·(1-τ) + o·τ`` is bit-exact with the reference's: two f32
products and their sum, rounded once into the target's dtype, never a
fused ``add(alpha=)``, which rounds the product and the sum as one.

``AdamConfig.state_dtype`` sets the moments' dtype, as the reference's:
``None`` (or ``"float32"``) keeps f32 moments, updated in place;
``"bfloat16"`` halves their memory.  Then ``update`` follows the
reference's order: new f32 moments from the stored ones, the step from
those unrounded values, and only then one rounding into bf16.  Each
product and sum is its own op (no ``alpha=``, no ``addcmul``), and the
square root is correctly rounded on every device, so that this path is
the reference's arithmetic bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

GROUP_ELEMS = 1 << 26     # elements per group of _foreach ops


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0          # global-norm clip; 0 disables
    state_dtype: Optional[str] = None   # None → f32 m/v; "bfloat16" halves them


class AdamState(NamedTuple):
    count: torch.Tensor        # int32 scalar
    m: List[torch.Tensor]
    v: List[torch.Tensor]


STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init(params: Sequence[torch.Tensor], cfg: AdamConfig) -> AdamState:
    params = list(params)
    dt = STATE_DTYPES[cfg.state_dtype] if cfg.state_dtype else torch.float32
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        m=[torch.zeros_like(p, dtype=dt) for p in params],
        v=[torch.zeros_like(p, dtype=dt) for p in params])


def _groups(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Consecutive indices of ``tensors`` in groups of at most
    ``GROUP_ELEMS`` elements (a larger tensor is a group of its own)."""
    groups: List[List[int]] = [[]]
    size = 0
    for i, t in enumerate(tensors):
        if groups[-1] and size + t.numel() > GROUP_ELEMS:
            groups.append([])
            size = 0
        groups[-1].append(i)
        size += t.numel()
    return [g for g in groups if g]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The l2 norm over every element of every tensor.  A DTensor's sum of
    squares is reduced over its shards first (``full_tensor``), so on a
    mesh the norm is the whole model's on every rank, never a rank's own
    piece's."""
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    sq = [t.full_tensor() if _is_dtensor(t) else t for t in sq]
    return torch.sqrt(torch.stack(sq).sum())


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _copy_(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``torch._foreach_copy_``; DTensor has no sharding rule for it, so
    DTensors (pieces placed alike) take one ``copy_`` each."""
    if dst and _is_dtensor(dst[0]):
        for d, x in zip(dst, src):
            d.copy_(x)
    else:
        torch._foreach_copy_(dst, src)


def _sqrt_(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Correctly rounded f32 square roots, as the reference's: in place on
    CUDA, whose sqrt is correctly rounded.  torch's vectorized CPU sqrt
    misses by an ulp on ~1 % of f32 inputs, so CPU tensors go through f64,
    whose root rounds to the correctly rounded f32 (new tensors)."""
    if xs[0].device.type == "cpu":
        return [torch.sqrt(x.double()).float() for x in xs]
    torch._foreach_sqrt_(xs)
    return xs


def _update_rounded_once(g, m, v, p, cfg: AdamConfig, b1c, b2c) -> None:
    """One group's step with moments narrower than f32: the reference's
    ``upd``, op for op, in f32 copies of the moments; the moments rounded
    once from those copies, and the step taken from the unrounded f32
    values, in the same buffers.  Empties ``g`` once the moments are
    taken, so that at most four f32 copies of the group are alive."""
    m32 = [x.float() for x in m]
    torch._foreach_mul_(m32, cfg.b1)
    torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.b1))
    v32 = [x.float() for x in v]
    torch._foreach_mul_(v32, cfg.b2)
    sq = torch._foreach_mul(g, g)
    g.clear()
    torch._foreach_mul_(sq, 1 - cfg.b2)
    torch._foreach_add_(v32, sq)
    del sq
    _copy_(m, m32)
    _copy_(v, v32)
    # step = lr · (m / b1c) / (sqrt(v / b2c) + eps)
    torch._foreach_div_(m32, b1c)
    torch._foreach_mul_(m32, cfg.lr)
    torch._foreach_div_(v32, b2c)
    denom = _sqrt_(v32)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_div_(m32, denom)
    del denom, v32
    if cfg.weight_decay:
        torch._foreach_add_(m32, torch._foreach_mul([x.float() for x in p],
                                                    cfg.lr * cfg.weight_decay))
    torch._foreach_sub_(p, m32)


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state: AdamState,
           params: Sequence[torch.Tensor], cfg: AdamConfig
           ) -> Tuple[AdamState, torch.Tensor]:
    """One Adam step, in place on ``params`` and the moments.  Returns
    (new state, pre-clip grad norm).  Moments narrower than f32 (bf16,
    ``state_dtype``) take the reference's round-once order; f32 moments
    are updated in place."""
    grads, params = list(grads), list(params)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if cfg.grad_clip > 0 else None)
    count = state.count + 1
    countf = count.float()
    b1c = 1.0 - cfg.b1 ** countf
    b2c = 1.0 - cfg.b2 ** countf
    for group in _groups(params):
        g = [grads[i].float() for i in group]
        if scale is not None:
            g = list(torch._foreach_mul(g, scale))
        m, v, p = ([x[i] for i in group] for x in (state.m, state.v, params))
        if m[0].dtype != torch.float32:
            _update_rounded_once(g, m, v, p, cfg, b1c, b2c)
            continue
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        del g
        # step = lr · (m / b1c) / (sqrt(v / b2c) + eps)
        denom = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        step = torch._foreach_div(m, b1c)
        torch._foreach_mul_(step, cfg.lr)
        torch._foreach_div_(step, denom)
        del denom
        if cfg.weight_decay:
            torch._foreach_add_(step, p, alpha=cfg.lr * cfg.weight_decay)
        torch._foreach_sub_(p, step)
    return AdamState(count, state.m, state.v), gnorm


@torch.no_grad()
def ema_update(target: Sequence[torch.Tensor], online: Sequence[torch.Tensor],
               tau: float, where: Optional[torch.Tensor] = None) -> None:
    """Polyak target update ``t ← t·(1-τ) + o·τ``, in place on ``target``:
    both products and their sum in f32, rounded once into the target's
    dtype, as ``repro.optim.adam.ema_update``.  With ``where`` (a bool
    scalar tensor) a target moves only where it is true and otherwise
    keeps every bit, as the reference's ``jnp.where(cond, ema, t)``."""
    target, online = list(target), list(online)
    for group in _groups(target):
        t = [target[i] for i in group]
        new = torch._foreach_mul([x.float() for x in t], 1 - tau)
        torch._foreach_add_(new, torch._foreach_mul([online[i].float() for i in group], tau))
        if where is not None:
            new = [torch.where(where, n, x) for n, x in zip(new, t)]
        _copy_(t, new)
