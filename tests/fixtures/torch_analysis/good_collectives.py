# ruff: noqa
"""Known-good collective fixtures: a rank-dependent branch around host
work only, uniform loops over the mesh axes, and known axis names."""
import torch.distributed as dist

from repro_torch.optim.collectives import all_reduce_axes, fused_tree_reduce


def report(errs, mesh):
    dist.all_reduce(errs, op=dist.ReduceOp.MAX, group=mesh.group("pod"))
    if dist.get_rank() == 0:
        print(float(errs[0]))


def reduce(vec, axes, mesh):
    for ax in axes:                        # the same axes on every rank
        vec = all_reduce_axes(vec, (ax,), mesh)
    return fused_tree_reduce([vec], ("pod", "data"), mesh)


def device_mesh(DeviceMesh, ranks):
    return DeviceMesh("cuda", ranks, mesh_dim_names=("data", "model"))
