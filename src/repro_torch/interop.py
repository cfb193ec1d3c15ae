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

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.agents.base import AgentState, MLP
from repro_torch.agents.token_dqn import TrainState
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


def param_leaves_from_numpy(tree, device="cpu"):
    """A params-shaped reference tree (a gradient, an error-feedback
    buffer) → the list of tensors in ``params.parameters()`` order: a
    list of layers as ``flatten_mlp``, a dict of them in sorted key order."""
    layers = ([x for k in sorted(tree) for x in flatten_mlp(tree[k])]
              if isinstance(tree, dict) else flatten_mlp(tree))
    return [_t(x, device) for x in layers]


def _moment(x, device) -> torch.Tensor:
    """A reference Adam moment in its own dtype: bf16 (``state_dtype``)
    through f32, which holds it exactly, else as it is."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return _f32(x, device).to(torch.bfloat16)
    return _t(x, device)


def _adam_from_numpy(opt, flatten, device) -> AdamState:
    return AdamState(count=_t(opt.count, device).to(torch.int32),
                     m=[_moment(x, device) for x in flatten(opt.m)],
                     v=[_moment(x, device) for x in flatten(opt.v)])


def agent_state_from_numpy(state, device="cpu",
                           generator_seed: Optional[int] = None) -> AgentState:
    """Reference ``AgentState`` → the port's.  Its params are an MLP (DQN)
    or a dict of MLPs (DDPG, TD3, SAC), which becomes an
    ``nn.ModuleDict`` in sorted key order with the Adam moments in the
    same order.  SAC's ``extra`` (log-alpha, its ``AdamState``) is carried
    over.  ``generator_seed`` appends the learn-time ``torch.Generator``
    that the port's TD3 and SAC keep in ``extra`` (``td3.LEARN_SEED``,
    ``sac.LEARN_SEED``), which the reference has no counterpart of."""
    if isinstance(state.params, dict):
        keys = sorted(state.params)

        def build(tree):
            return nn.ModuleDict({k: mlp_from_numpy(tree[k], device) for k in keys})

        def flatten(tree):
            return [x for k in keys for x in flatten_mlp(tree[k])]
    else:
        build, flatten = functools.partial(mlp_from_numpy, device=device), flatten_mlp
    extra = ()
    if len(state.extra):
        log_alpha, alpha_opt = state.extra
        extra = (_t(log_alpha, device).to(torch.float32),
                 _adam_from_numpy(alpha_opt, lambda x: [x], device))
    if generator_seed is not None:
        extra += (torch.Generator(device=device).manual_seed(generator_seed),)
    return AgentState(params=build(state.params),
                      target=build(state.target).requires_grad_(False),
                      opt=_adam_from_numpy(state.opt, flatten, device),
                      step=_t(state.step, device).to(torch.int32), extra=extra)


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


# the reference's layer stacks, each on a leading layer axis
STACKED = ("units", "enc_units", "dec_units")


def backbone_leaf(tree, name: str) -> np.ndarray:
    """The reference's array for the port's ``Backbone`` parameter
    ``name`` (``embed.tok``, ``units.3.attn.w.wq``, ``units.1.moe.w.router``,
    ``units.1.moe.w.shared.w_up``, ``units.0.hybrid.ssm.w_x``,
    ``blocks.1.slstm.rz``, ``enc_pos``, ``enc_units.2.attn_nc.w.wq``,
    ``dec_units.0.cross.w.wk``, ``final_norm.scale`` …) in the port's
    layout: ``units`` (Whisper's ``enc_units`` and ``dec_units``)
    un-stacked, dense weights (the shared expert's, a hybrid layer's
    attention and SSM, an xLSTM block's included) and the output
    projection transposed to (out, in); the router (d, E), the expert
    stacks (E, d, f) / (E, f, d) and the sLSTM's recurrent (H, hd, hd) as
    the reference keeps them.  A unit's duplicate kinds (Llama-4's two
    ``attn``) are one entry in both trees; the xLSTM ``blocks`` are a
    list in the reference.  ``tree`` is a params tree or an Adam moment
    tree of the same structure."""
    parts = name.split(".")
    if parts[0] in STACKED or parts[0] == "blocks":
        i, path = int(parts[1]), parts[2:]
        x = tree[parts[0]] if parts[0] in STACKED else tree["blocks"][i]
        for key in path:
            x = x[key]
        x = np.asarray(x)[i] if parts[0] in STACKED else np.asarray(x)
        return x.T if x.ndim == 2 and path[-1] != "router" else x
    x = tree
    for key in parts:
        x = x[key]
    x = np.asarray(x)
    return x.T if name == "embed.out" else x


def _f32(x, device) -> torch.Tensor:
    """Via f32, which holds bf16 exactly; ``copy_`` casts back."""
    return torch.as_tensor(np.array(x, np.float32), device=device)


def backbone_params_from_numpy(cfg: ModelConfig, params, device="cpu") -> backbone.Backbone:
    """Reference backbone params (nested dicts of numpy arrays, ``units``,
    ``enc_units`` and ``dec_units`` stacked on a leading axis, dense
    weights (in, out)) → the port's
    ``Backbone`` (dense weights (out, in)), in the config's dtype."""
    model = backbone.Backbone(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_f32(backbone_leaf(params, name), device))
    return model


def train_state_from_numpy(cfg: ModelConfig, state, device="cpu") -> TrainState:
    """Reference token-DQN ``TrainState`` (params, target, Adam count/m/v,
    step) → the port's ``agents.token_dqn.TrainState``, the moments in
    ``Backbone.parameters()`` order with the same transposes and in their
    own dtype (f32, or bf16 with ``state_dtype``)."""
    params = backbone_params_from_numpy(cfg, state.params, device)
    target = backbone_params_from_numpy(cfg, state.target, device).requires_grad_(False)
    names = [n for n, _ in params.named_parameters()]
    opt = AdamState(count=_t(state.opt.count, device).to(torch.int32),
                    m=[_moment(backbone_leaf(state.opt.m, n), device) for n in names],
                    v=[_moment(backbone_leaf(state.opt.v, n), device) for n in names])
    return TrainState(params=params, target=target, opt=opt,
                      step=_t(state.step, device).to(torch.int32))
