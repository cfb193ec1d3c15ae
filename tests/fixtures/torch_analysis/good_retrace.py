# ruff: noqa
"""Known-good host-sync fixtures: decisions on host-side inputs, shape
and metadata probes, None checks, membership and container tests, and
the data kept on the device.  ``step`` (with the host-side inputs
``env_steps`` and ``count``) is the step program: the test passes it to
``retrace.sync_sites`` as its root."""
from typing import List, Optional

import torch


def step(state, batch, warmup: int, grads: List[torch.Tensor],
         u: Optional[torch.Tensor] = None):
    if state.env_steps < warmup or state.replay.count == 0:
        return state
    if u is None:
        u = torch.rand(batch["obs"].shape[0], device=batch["obs"].device)
    if batch["obs"].dim() == 2 and "action" in batch and grads:
        loss = torch.where(u > 0.5, batch["reward"], torch.zeros_like(u))
    else:
        loss = u
    n = len(grads)
    batch["seen"][0] = loss.sum()       # a device value written on the device
    return _kind(loss), n


def _kind(x):
    return "cpu" if x.device.type == "cpu" else "cuda"


def not_a_program(x):
    return x.item()                     # no step program reaches it
