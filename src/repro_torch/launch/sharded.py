"""Model sharding over a mesh of ranks: the token-DQN train step with its
state and batch as DTensors, and the serving parameters (``shard_params``)
that ``prefill``, ``decode_step``, ``serve_step``, ``DecodeEngine`` and
``ActorServer`` take with ``shd``.

The reference shards the model with GSPMD in one program over a device
mesh.  Here each shard is a rank of ``torch.distributed`` (``launch/mesh.py::
spawn`` starts them) and a sharded tensor is a DTensor on the
``DeviceMesh`` of the port's ``Mesh`` (``mesh.to_device_mesh``): the
parameters, the target and the Adam moments placed by
``token_dqn.state_specs`` through ``specs.placements_for`` (ZeRO-1: the
moments as the parameters), the batch by ``specs.batch_specs``.  The step
is ``token_dqn.train_step`` itself on ``shard_train_state``'s state and
``shard_batch``'s batch: its constraint points redistribute, the flash
kernels run on each rank's (batch, heads) piece, and the gradients are
reduced onto the parameters' placements.

Each rank cuts its pieces from the same full tensors (``specs.
shard_tensor``, no communication), so a 1×1 mesh holds the unsharded state
bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.launch import specs as S
from repro_torch.models import backbone
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, ShardingConfig
from repro_torch.optim import adam


def shard_module_(module: nn.Module, specs: Dict[str, tuple], device_mesh) -> None:
    """Replace each parameter of ``module`` by this rank's piece of it under
    ``specs`` ({name: spec}), a DTensor parameter (same ``requires_grad``);
    the full tensor is released once nothing else holds it."""
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        piece = S.shard_tensor(p.detach(), specs[name], device_mesh)
        setattr(owner, leaf, nn.Parameter(piece, requires_grad=p.requires_grad))


def shard_params(cfg: ModelConfig, shd: ShardingConfig, params: backbone.Backbone,
                 device_mesh) -> backbone.Backbone:
    """The serving parameters on a mesh: the full network (the same on
    every rank) cut in place into this rank's pieces by ``param_specs``;
    returns ``params``."""
    shard_module_(params, backbone.param_specs(cfg, shd, params), device_mesh)
    return params


def shard_train_state(cfg: ModelConfig, shd: ShardingConfig, tcfg: token_dqn.TokenDQNConfig,
                      params: backbone.Backbone, target: backbone.Backbone,
                      device_mesh) -> token_dqn.TrainState:
    """A train state at its start on a mesh: the full online and target
    networks (the same on every rank) cut into this rank's pieces by
    ``param_specs`` (the modules are changed in place), and the Adam
    moments made zero on those pieces (``adam.init``; ZeRO-1, as
    ``state_specs``), so the full moments are never allocated: at
    InternLM2-1.8B's 1.89 B parameters a rank holds each full bf16 network
    (3.8 GB) until it is cut, and never the 15.1 GB of full f32 moments.
    ``count`` and ``step`` are plain zero scalars, the same on every
    rank."""
    shard_params(cfg, shd, params, device_mesh)
    shard_params(cfg, shd, target, device_mesh)
    dev = next(iter(params.parameters())).device
    return token_dqn.TrainState(params=params, target=target,
                                opt=adam.init(params.parameters(), tcfg.opt),
                                step=torch.zeros((), dtype=torch.int32, device=dev))


def shard_batch(shd: ShardingConfig, batch: Dict[str, torch.Tensor],
                device_mesh) -> Dict[str, torch.Tensor]:
    """The full batch (the same on every rank) → this rank's pieces, its
    batch axis over the data axes (``batch_specs``)."""
    specs = S.batch_specs(batch, shd)
    return {k: S.shard_tensor(v, specs[k], device_mesh) for k, v in batch.items()}


def full_state(state: token_dqn.TrainState) -> Dict[str, torch.Tensor]:
    """{name: whole tensor} of every tensor of a (sharded) ``TrainState``
    (``agents.base.state_tensors``'s names), each DTensor gathered."""
    return {k: (t.full_tensor() if L.is_dtensor(t) else t).detach()
            for k, t in state_tensors(state).items()}


def local_state_bytes(state: token_dqn.TrainState) -> int:
    """Bytes of this rank's pieces of the state."""
    total = 0
    for t in state_tensors(state).values():
        local = t.to_local() if L.is_dtensor(t) else t
        total += local.numel() * local.element_size()
    return total


def state_device_bytes(cfg: ModelConfig, shd: ShardingConfig,
                       state: token_dqn.TrainState, mesh) -> float:
    """``specs.tree_device_bytes`` of the state under ``state_specs`` on
    ``mesh``: what each rank holds."""
    specs = token_dqn.state_spec_leaves(token_dqn.state_specs(cfg, shd, state))
    leaves = {k: (tuple(t.shape), t.dtype) for k, t in state_tensors(state).items()}
    return S.tree_device_bytes(leaves, specs, mesh)


def state_shapes(cfg: ModelConfig, shd: ShardingConfig, moments: str = "float32"
                 ) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """({name: (shape, dtype)}, {name: spec}) of a full-size ``TrainState``
    with ``moments`` ("float32" or "bfloat16") Adam moments, from shapes
    alone (the parameters on the meta device): what ``tree_device_bytes``
    needs to size a config on a mesh without allocating it."""
    params = backbone.shape_params(cfg)
    pspec = backbone.param_specs(cfg, shd, params)
    mdt = adam.STATE_DTYPES[moments]
    leaves: Dict[str, tuple] = {}
    specs: Dict[str, tuple] = {}
    for name, p in params.named_parameters():
        for key, dtype in ((f"params/{name}", p.dtype), (f"target/{name}", p.dtype),
                           (f"opt/m/{name}", mdt), (f"opt/v/{name}", mdt)):
            leaves[key], specs[key] = (tuple(p.shape), dtype), pspec[name]
    for key in ("opt/count", "step"):
        leaves[key], specs[key] = ((), torch.int32), ()
    return leaves, specs
