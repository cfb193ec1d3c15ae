"""Spec primitives of the model layer — the axis arithmetic of
``repro.launch.specs`` that the model's constraint points
(``layers.shard``) and spec rules (``backbone.param_specs``,
``_cache_kv_spec``) need; ``launch/specs.py`` builds the spec trees and
the bytes per device on them.

A spec is a tuple with one entry per tensor dimension: ``None``, an axis
name, or a tuple of axis names (the dimension split over all of them,
the first outermost), the reference's ``PartitionSpec`` as a plain tuple
(``canonical``: a one-axis tuple spelled as its name, as ``PartitionSpec``
spells it).
``valid_spec`` drops an axis name from a dimension it does not divide, as
the reference does before it builds a ``NamedSharding``;
``placements_for`` turns a valid spec into DTensor placements on a mesh
(``Shard(dim)`` on each mesh dimension a tensor dimension is split over,
``Replicate()`` on the others), the counterpart of ``shardings_for``; a
dimension of one element stays whole (it can be "split" only over an axis
of one rank, where both hold the same data, and DTensor's view rules take
such a split for a real one).
A mesh here is ``launch.mesh.Mesh`` (or a ``DeviceMesh``): only its axis
names and sizes are read, so a mesh that only describes a shape serves
the spec arithmetic.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


def canonical(spec: Spec) -> Spec:
    """A spec as ``PartitionSpec`` spells it: a one-axis tuple entry as the
    bare axis name (``("data",)`` → ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``launch.mesh.Mesh`` or a ``DeviceMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, (tuple, list)):
        return math.prod(shape[a] for a in entry)
    return shape[entry]


def valid_spec(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """Drop axis names on dimensions they don't divide; one entry per
    dimension (a longer spec is cut to the tensor's rank, as the
    reference's ``zip``)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(entry if entry is not None and dim % axis_size(mesh, entry) == 0 else None
                 for dim, entry in zip(shape, entries))


def placements_for(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """DTensor placements, one per mesh dimension in the mesh's axis order,
    for a tensor of ``shape`` under ``spec`` (made valid first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(valid_spec(shape, spec, mesh)):
        if shape[dim] == 1:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def num_shards(shape: Sequence[int], spec: Spec, mesh) -> int:
    """Into how many pieces a tensor of ``shape`` is split under ``spec``."""
    return math.prod(axis_size(mesh, e) for e in valid_spec(shape, spec, mesh))


def full(shape: Sequence[int], value: float, dtype, spec: Spec = (), device_mesh=None,
         device=None):
    """``torch.full(shape, value)`` on ``device``; with a ``device_mesh``
    this rank's piece of it under ``spec`` (on ``device``, the meta device
    included), a DTensor on the mesh: no rank makes the whole tensor.  The
    valid spec splits only dimensions it divides, so every piece is the
    same size."""
    if device_mesh is None:
        return torch.full(tuple(shape), value, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    placements = placements_for(shape, spec, device_mesh)
    local = list(shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= device_mesh.size(mdim)
    piece = torch.full(tuple(local), value, dtype=dtype, device=device)
    return DTensor.from_local(piece, device_mesh, placements, run_check=False)
