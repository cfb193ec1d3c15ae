"""Agent API (paper §II-A): act(s) → a, learn(data, is) → new priorities
— port of ``repro.agents.base``.

An ``Agent`` is a bundle of functions over an ``AgentState``; ``learn``
returns per-item |TD| for the replay's priority write-back.  The
networks are ``nn.Module``s and ``learn`` updates them **in place** (the
returned state holds the same modules).  ``state_tensors`` names every
tensor of a state for the checkpoint manager.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.optim import adam


class AgentState(NamedTuple):
    params: nn.Module          # online network
    target: nn.Module          # target network
    opt: Any                   # optimizer state (optim.adam.AdamState)
    step: torch.Tensor         # int32 scalar learn-step counter
    extra: Any = ()            # algorithm-specific (SAC's log-alpha and its
                               # Adam state; TD3's and SAC's learn generator)


def default_params_for_acting(state: AgentState) -> nn.Module:
    """The module ``act`` reads: every built-in agent acts on
    ``state.params`` (DQN's Q-network, the actor-critics' ``pi`` inside
    it), so the whole online module is the snapshot unit."""
    return state.params


def default_with_acting_params(state: AgentState, params: nn.Module) -> AgentState:
    """Inverse of ``default_params_for_acting``: put a (possibly stale)
    acting copy in the state handed to ``act``."""
    return state._replace(params=params)


@dataclasses.dataclass(frozen=True)
class Agent:
    """act/learn function bundle; see dqn.py, ddpg.py, td3.py and sac.py
    for the constructors.

    ``grads``/``apply_grads`` split ``learn`` in two
    (``learn ≡ apply_grads(state, *grads(state, batch, is_w))``) and
    expose the gradients between the phases.

    ``params_for_acting``/``with_acting_params`` are the double-buffer
    contract of the async loop: ``init_loop_state(double_buffer=True)``
    deep-copies ``params_for_acting(state)`` once into
    ``LoopState.actor_params``, every ``publish_interval`` iterations the
    loop copies the fresh module's tensors into it in place, and actors
    act on ``with_acting_params(state, actor_params)`` (runtime/loop.py).
    The defaults cover every agent whose ``act`` reads only
    ``state.params``; override both together otherwise.
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
    params_for_acting: Callable[[AgentState], nn.Module] = default_params_for_acting
    with_acting_params: Callable[[AgentState, nn.Module], AgentState] = \
        default_with_acting_params


def _named_leaves(prefix: str, x) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of a nest of NamedTuples, lists and tuples whose
    leaves are tensors or generators; a NamedTuple's fields by name, a
    sequence's items by position."""
    if isinstance(x, (torch.Tensor, torch.Generator)):
        yield prefix, x
    elif hasattr(x, "_fields"):
        for f in x._fields:
            yield from _named_leaves(f"{prefix}/{f}", getattr(x, f))
    elif isinstance(x, (list, tuple)):
        for i, item in enumerate(x):
            yield from _named_leaves(f"{prefix}/{i}", item)
    else:
        raise TypeError(f"{prefix}: {type(x).__name__} is not a tensor, a generator "
                        "or a nest of them")


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of an agent's state by name (the checkpoint's keys):
    ``params/<name>``, ``target/<name>``, ``opt/count``, ``opt/m/<name>``,
    ``opt/v/<name>``, ``step`` and, where the state has them,
    ``extra/...``.  The same tensors, not copies, so a checkpoint restores
    into them in place; a ``torch.Generator`` in ``extra`` enters as its
    ``get_state()`` (a new uint8 tensor), which ``load_generators`` sets
    back after a restore.  Also a token-DQN ``TrainState``'s."""
    names = [n for n, _ in state.params.named_parameters()]
    out = {f"params/{n}": p for n, p in state.params.named_parameters()}
    out.update({f"target/{n}": p for n, p in state.target.named_parameters()})
    out["opt/count"] = state.opt.count
    out.update({f"opt/m/{n}": m for n, m in zip(names, state.opt.m)})
    out.update({f"opt/v/{n}": v for n, v in zip(names, state.opt.v)})
    out["step"] = state.step
    for name, leaf in _named_leaves("extra", getattr(state, "extra", ())):
        out[name] = leaf.get_state() if isinstance(leaf, torch.Generator) else leaf
    return out


def generator_names(state) -> set:
    """The ``state_tensors`` names that hold a generator's state."""
    return {name for name, leaf in _named_leaves("extra", getattr(state, "extra", ()))
            if isinstance(leaf, torch.Generator)}


def load_generators(state: AgentState, tensors: Dict[str, torch.Tensor]) -> None:
    """Set each generator of ``state.extra`` from its entry of ``tensors``
    (a ``state_tensors(state)`` dict that a checkpoint was restored
    into)."""
    for name, leaf in _named_leaves("extra", state.extra):
        if isinstance(leaf, torch.Generator):
            leaf.set_state(tensors[name])


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


def actor_critic_state(gen: torch.Generator, opt_cfg, sizes: Dict[str, Sequence[int]],
                       extra: Any = ()) -> AgentState:
    """Initial state of an actor-critic: ``params`` an ``nn.ModuleDict`` of
    one ``mlp_init`` network per entry of ``sizes``, registered in sorted
    name order (the order in which JAX flattens the reference's params
    dict, so the Adam moments map one to one), the target a copy, zero
    moments."""
    params = nn.ModuleDict({name: mlp_init(gen, sizes[name]) for name in sorted(sizes)})
    target = copy.deepcopy(params).requires_grad_(False)
    return AgentState(params=params, target=target,
                      opt=adam.init(params.parameters(), opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=gen.device),
                      extra=extra)


def q_value(net: nn.Module, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Q(s, a) of a critic MLP over ``[obs, act]`` → (B,)."""
    return net(torch.cat([obs, act], -1))[..., 0]
