"""Sharding specs — port of ``repro.launch.specs`` and of
``repro.launch.dryrun.tree_device_bytes``: the batch and cache spec trees
and the bytes one device holds under a spec tree.  The spec primitives
(``canonical``, ``axis_size``, ``valid_spec``, ``placements_for``,
``num_shards``) live with the model in ``models/sharding.py``, whose
constraint points need them, and are the reference's names here too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig, ShardingConfig
from repro_torch.models.sharding import (  # noqa: F401  (the reference's names)
    Spec, axis_size, canonical, num_shards, placements_for, valid_spec)


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    shape, dtype = leaf
    return tuple(shape), dtype


def tree_device_bytes(leaves: Mapping[str, Any], specs: Mapping[str, Spec], mesh) -> float:
    """Bytes one device holds of ``leaves`` ({name: tensor or (shape,
    dtype)}) sharded by ``specs`` ({name: spec}) over ``mesh``: each leaf's
    bytes over its number of shards, summed (``repro.launch.dryrun.
    tree_device_bytes``)."""
    total = 0.0
    for name, leaf in leaves.items():
        shape, dtype = _shape_dtype(leaf)
        itemsize = torch.empty((), dtype=dtype).element_size()
        total += math.prod(shape) * itemsize / num_shards(shape, specs[name], mesh)
    return total


def batch_specs(batch_shapes: Mapping[str, Any], shd: ShardingConfig) -> Dict[str, Spec]:
    """Learner/actor batch: leading batch dim over the data axes."""
    dp = shd.fsdp
    return {k: canonical((dp,) + (None,) * (len(_shape_dtype(v)[0]) - 1))
            for k, v in batch_shapes.items()}


def cache_specs(cfg: ModelConfig, shd: ShardingConfig, cache) -> Dict[str, Any]:
    """Spec tree mirroring ``backbone.init_cache``'s: K/V (and Whisper's
    cross K/V) by ``backbone._cache_kv_spec``, the hybrid SSM state
    (U, B, H, N, P) over the data axes on its batch dimension, each xLSTM
    block state (B, H, ...) on its batch dimension, and ``pos``
    replicated."""
    dp = shd.fsdp
    kv_spec = backbone._cache_kv_spec(cfg, shd)
    out: Dict[str, Any] = {}
    for name, leaf in cache.items():
        if name in ("k", "v", "cross_k", "cross_v"):
            out[name] = kv_spec
        elif name == "ssm":
            out[name] = canonical((None, dp, None, None, None))
        elif name == "blocks":
            out[name] = [{kind: [canonical((dp,) + (None,) * (len(_shape_dtype(t)[0]) - 1))
                                 for t in state] for kind, state in block.items()}
                         for block in leaf]
        else:
            out[name] = ()
    return out


def flat_leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/0": leaf} of a tree of dicts, lists and tuples (cache trees,
    spec trees): the flattening ``tree_device_bytes`` takes.  A spec (a
    tuple of axis entries) is a leaf."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree and
                                  not _is_spec(tree) and not _is_shape_dtype(tree)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def _is_shape_dtype(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def shard_tensor(full: torch.Tensor, spec: Spec, device_mesh):
    """This rank's piece of ``full`` under ``spec`` as a DTensor on
    ``device_mesh``: each rank cuts its own piece from the same full tensor
    (no communication), so a 1×1 mesh holds ``full`` itself bit for bit."""
    from torch.distributed.tensor import DTensor, Shard

    placements = placements_for(full.shape, spec, device_mesh)
    local = full
    coords = device_mesh.get_coordinate()
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = device_mesh.size(mdim)
            local = local.chunk(n, dim=pl.dim)[coords[mdim]]
    local = (local.detach().clone(memory_format=torch.contiguous_format)
             if local is not full else local.detach())
    return DTensor.from_local(local, device_mesh, placements, run_check=False)
