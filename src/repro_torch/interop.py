"""Carry state across from the JAX reference, as numpy arrays.

The arguments are the reference's state objects after
``jax.device_get`` (NamedTuples/dataclasses whose leaves are numpy
arrays); this module reads their fields and imports no JAX.  Parity
tests use it to start the port from exactly the reference's state.

The reference stores a dense layer as ``w`` of shape (in, out) for
``x @ w``; ``nn.Linear`` keeps (out, in), so weights (and their Adam
moments) are transposed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.agents.base import AgentState, MLP
from repro_torch.core.replay import ReplayState
from repro_torch.envs.classic import EnvState
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import AdamState


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def flatten_mlp(layers: Sequence[dict]):
    """[{"w", "b"}, ...] → [w0ᵀ, b0, w1ᵀ, b1, ...] in ``nn.Linear`` layout,
    the order of ``MLP.parameters()``."""
    out = []
    for layer in layers:
        out += [np.asarray(layer["w"]).T, np.asarray(layer["b"])]
    return out


def mlp_from_numpy(layers: Sequence[dict], device="cpu") -> MLP:
    sizes = [np.asarray(layers[0]["w"]).shape[0]] + [
        np.asarray(layer["w"]).shape[1] for layer in layers]
    net = MLP(sizes, device=device)
    with torch.no_grad():
        for p, x in zip(net.parameters(), flatten_mlp(layers)):
            p.copy_(_t(x, device))
    return net


def agent_state_from_numpy(state, device="cpu") -> AgentState:
    """Reference ``AgentState`` (MLP params/target, ``AdamState`` opt) →
    the port's."""
    params = mlp_from_numpy(state.params, device)
    target = mlp_from_numpy(state.target, device).requires_grad_(False)
    opt = AdamState(count=_t(state.opt.count, device).to(torch.int32),
                    m=[_t(x, device) for x in flatten_mlp(state.opt.m)],
                    v=[_t(x, device) for x in flatten_mlp(state.opt.v)])
    return AgentState(params=params, target=target, opt=opt,
                      step=_t(state.step, device).to(torch.int32))


def replay_state_from_numpy(state, device="cpu") -> ReplayState:
    """Reference ``ReplayState`` → the port's (head/count/pending become
    host ints)."""
    return ReplayState(
        tree=_t(state.tree, device),
        storage={k: _t(v, device) for k, v in state.storage.items()},
        head=int(state.head), count=int(state.count),
        max_priority=_t(state.max_priority, device).to(torch.float32),
        pending=int(state.pending))


def env_state_from_numpy(state, device="cpu") -> EnvState:
    """Reference batched ``EnvState(x, t)`` → the port's."""
    return EnvState(x=_t(state.x, device).to(torch.float32),
                    t=_t(state.t, device).to(torch.int32))


def backbone_params_from_numpy(cfg: ModelConfig, params, device="cpu") -> backbone.Backbone:
    """Reference backbone params (nested dicts of numpy arrays, ``units``
    stacked on a leading axis, dense weights (in, out)) → the port's
    ``Backbone`` (dense weights (out, in)), in the config's dtype."""
    model = backbone.Backbone(cfg, device)

    def f32(x):   # via f32, which holds bf16 exactly; copy_ casts back
        return torch.as_tensor(np.array(x, np.float32), device=device)

    with torch.no_grad():
        model.embed.tok.copy_(f32(params["embed"]["tok"]))
        if model.embed.out is not None:
            model.embed.out.copy_(f32(np.asarray(params["embed"]["out"]).T))
        model.final_norm.scale.copy_(f32(params["final_norm"]["scale"]))
        if model.final_norm.bias is not None:
            model.final_norm.bias.copy_(f32(params["final_norm"]["bias"]))
        for i, unit in enumerate(model.units):
            for kind, sub in unit.items():
                ref = params["units"][kind]
                for name, p in sub.norm.named_parameters():
                    p.copy_(f32(np.asarray(ref["norm"][name])[i]))
                for name, p in sub.w.named_parameters():
                    x = np.asarray(ref["w"][name])[i]
                    p.copy_(f32(x.T if x.ndim == 2 else x))
    return model
