"""Agent API (paper §II-A): act(s) → a, learn(data, is) → new priorities
— port of ``repro.agents.base``.

An ``Agent`` is a bundle of functions over an ``AgentState``; ``learn``
returns per-item |TD| for the replay's priority write-back.  The
networks are ``nn.Module``s and ``learn`` updates them **in place** (the
returned state holds the same modules).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn


class AgentState(NamedTuple):
    params: nn.Module          # online network
    target: nn.Module          # target network
    opt: Any                   # optimizer state (optim.adam.AdamState)
    step: torch.Tensor         # int32 scalar learn-step counter


@dataclasses.dataclass(frozen=True)
class Agent:
    """act/learn function bundle; see dqn.py for the constructor.

    ``grads``/``apply_grads`` split ``learn`` in two
    (``learn ≡ apply_grads(state, *grads(state, batch, is_w))``) and
    expose the gradients between the phases.
    """

    name: str
    init: Callable[[torch.Generator], AgentState]
    act: Callable[..., torch.Tensor]   # (state, obs, generator, epsilon) → action
    learn: Callable[..., Tuple[AgentState, Dict[str, torch.Tensor], torch.Tensor]]
    # learn(state, batch, is_weights) → (state', metrics, |td|)
    grads: Optional[Callable] = None
    # grads(state, batch, is_weights) → (grad list, aux)
    apply_grads: Optional[Callable] = None
    # apply_grads(state, grad list, aux) → (state', metrics, |td|)


class MLP(nn.Module):
    """ReLU multilayer perceptron; layer ``i`` maps sizes[i] → sizes[i+1]."""

    def __init__(self, sizes: Sequence[int], device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def mlp_init(gen: torch.Generator, sizes: Sequence[int]) -> MLP:
    """Glorot-normal weights, zero biases, on the generator's device (the
    reference's ``mlp_init`` distribution; other random numbers)."""
    net = MLP(sizes, device=gen.device)
    with torch.no_grad():
        for layer in net.layers:
            b, a = layer.weight.shape
            layer.weight.copy_(torch.randn((b, a), generator=gen, device=gen.device)
                               * (2.0 / (a + b)) ** 0.5)
            layer.bias.zero_()
    return net
