# ruff: noqa
"""Known-bad collective fixtures for the port's lint.

C201: a collective under control flow that reads a per-rank source.
C202: an axis name outside {pod, data, model}.
"""
import time

import torch.distributed as dist

from repro_torch.optim.collectives import all_reduce_axes


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def report(errs, mesh):
    if dist.get_rank() == 0:
        dist.all_reduce(errs, group=mesh.group("pod"))      # C201


def save(vec, mesh):
    first = _rank() == 0
    if first:
        dist.broadcast(vec, src=0)                           # C201 (through a local and a def)


def timed(vec, mesh):
    while time.time() < 5.0:
        all_reduce_axes(vec, ("data",), mesh)               # C201


def typo(vec, mesh):
    dist.all_reduce(vec, group=mesh.group("pods"))          # C202
    return all_reduce_axes(vec, ("data", "modle"), mesh)    # C202
