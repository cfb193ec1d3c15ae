"""Fused mesh collectives — port of ``repro.optim.collectives``: one wire
launch per dtype group.

On a real multi-process transport every collective pays a fixed launch
latency that dwarfs the payload at gradient sizes, so ``fused_tree_reduce``
concatenates the leaves of each dtype into one wire vector, reduces it once
per mesh axis (``dist.all_reduce`` on that axis's process group) and
splits the result back.  Elementwise reductions commute with
concatenation: on an axis of one or two ranks the result is bit for bit
the per-leaf reduce's.  With three or more ranks gloo's ring splits the
vector into chunks, and an element's summation order follows its chunk,
so the two forms may differ in the last bit (every rank still holds the
same bits).

The transport is the process group's own: gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` and stages them through host memory
itself, NCCL keeps them on the card.  ``"mean"`` is a SUM followed by a
division by the axis size, as ``jax.lax.pmean`` is (gloo has no AVG).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tree = Union[Sequence[torch.Tensor], Dict[str, torch.Tensor]]
OPS = ("sum", "mean", "max")


def _flatten(tree: Tree) -> Tuple[List[torch.Tensor], Callable[[List], Tree]]:
    """(leaves, rebuild) of a list, tuple or dict of tensors."""
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        if hasattr(tree, "_fields"):        # a NamedTuple
            return list(tree), lambda xs: kind(*xs)
        return list(tree), lambda xs: kind(xs)
    raise TypeError(f"expected a list, tuple or dict of tensors, got {type(tree).__name__}")


def all_reduce_axes(vec: torch.Tensor, axes: Sequence[str], mesh, op: str = "mean"
                    ) -> torch.Tensor:
    """Reduce ``vec`` in place over each mesh axis in turn; returns it (a
    ``"mean"`` of an integer tensor returns a new f32 tensor, as
    ``pmean`` of an int promotes)."""
    if op not in OPS:
        raise ValueError(f"op={op!r}: expected one of {OPS}")
    for ax in axes:
        dist.all_reduce(vec, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=mesh.group(ax))
        if op == "mean":
            if not vec.is_floating_point():
                vec = vec.to(torch.float32)
            vec.div_(mesh.axis_size(ax))
    return vec


def fused_tree_reduce(tree: Tree, axes: Sequence[str], mesh, op: str = "mean",
                      select: Optional[Callable[[torch.Tensor], bool]] = None) -> Tree:
    """Reduce every leaf of ``tree`` over the mesh ``axes`` with one
    collective per dtype group per axis; returns the same structure with
    new tensors (the inputs are not written).

    ``op`` is ``"sum"``, ``"mean"`` or ``"max"``.  ``select`` filters by
    leaf (e.g. only floating dtypes); unselected leaves pass through
    untouched.  Leaves of different dtypes never share a wire vector, so a
    bf16-cast gradient leg and an f32 leg keep their own precision."""
    leaves, rebuild = _flatten(tree)
    if not leaves or not axes:
        return tree
    out = list(leaves)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(leaves):
        if select is None or select(x):
            groups.setdefault(x.dtype, []).append(i)
    for idxs in groups.values():
        vec = (leaves[idxs[0]].reshape(-1).clone() if len(idxs) == 1 else
               torch.cat([leaves[i].reshape(-1) for i in idxs]))
        vec = all_reduce_axes(vec, axes, mesh, op)
        for i, part in zip(idxs, torch.split(vec, [leaves[i].numel() for i in idxs])):
            out[i] = part.view(leaves[i].shape)
    return rebuild(out)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in place:
    one ``broadcast`` per dtype group over ``group`` (the whole world by
    default)."""
    tensors = list(tensors)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idxs in groups.values():
        vec = torch.cat([tensors[i].reshape(-1) for i in idxs])
        dist.broadcast(vec, src=src, group=group)
        parts = torch.split(vec, [tensors[i].numel() for i in idxs])
        torch._foreach_copy_([tensors[i] for i in idxs],
                             [p.view(tensors[i].shape) for i, p in zip(idxs, parts)])
