"""Meshes of ranks, and a local launcher — port of ``repro.launch.mesh``'s
``data_mesh`` and ``pod_data_mesh`` for the process model.

PyTorch has no single-controller ``shard_map``: each shard of the mesh is
one process, a rank of a ``torch.distributed`` process group.  A ``Mesh``
is this rank's view of the grid: the named axes and their sizes (row-major,
the first axis outermost: pod-major on ``("pod", "data")``), this rank's
coordinates and flattened shard id (its rank), and the process group of
its line along each axis.  ``axis_index`` and ``axis_size`` take the place
of ``jax.lax.axis_index`` and ``psum(1, axis)``; a collective over an axis
runs on ``group(axis)``.

Every rank creates every line's group, in the same order (all lines of the
first axis, then of the second), because ``dist.new_group`` is collective
over the whole world; each rank keeps the groups it belongs to.

``spawn`` starts ``world`` local ranks with the ``spawn`` start method
(never ``fork``: the parent may hold threads, a CUDA context or JAX),
joins them through a ``file://`` rendezvous in a fresh temporary
directory, and returns each rank's return value.  The backend is the
caller's choice, ``"gloo"`` or ``"nccl"``: several ranks on one card need
gloo (NCCL refuses two ranks on one GPU), NCCL needs a card per rank.
Nothing picks a backend or a device on its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a row-major grid of ranks.  ``groups`` maps
    each axis to the process group of this rank's line along it (empty
    on a mesh that only describes a shape, which can validate but not
    reduce)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int = 0
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_shards(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> Dict[str, int]:
        out, rest = {}, self.rank
        for name, size in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = rest % size
            rest //= size
        return {name: out[name] for name in self.axis_names}

    @property
    def shard_id(self) -> int:
        """The flattened row-major shard id: the rank itself."""
        return self.rank

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def group(self, name: str):
        if name not in self.groups:
            raise ValueError(f"mesh axis {name!r} has no process group on this "
                             f"mesh (axes {self.axis_names}); build the mesh with "
                             "data_mesh / pod_data_mesh inside a process group")
        return self.groups[name]


def _lines(sizes: Sequence[int], axis: int) -> List[List[int]]:
    """The ranks of every line along ``axis`` of a row-major grid, lines in
    row-major order of the other coordinates."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [i for i in range(len(sizes)) if i != axis]
    lines = []
    for flat in range(math.prod(sizes[i] for i in others)):
        base, rest = 0, flat
        for i in reversed(others):
            base += (rest % sizes[i]) * strides[i]
            rest //= sizes[i]
        lines.append([base + k * strides[axis] for k in range(sizes[axis])])
    return lines


def make_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int]) -> Mesh:
    """The mesh of the current process group: its world size must equal the
    product of ``axis_sizes`` (one rank a shard).  Creates one group per
    line of every axis, on every rank, in the same order."""
    axis_names, axis_sizes = tuple(axis_names), tuple(int(s) for s in axis_sizes)
    n = math.prod(axis_sizes)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {dict(zip(axis_names, axis_sizes))} needs a torch.distributed "
            f"process group of {n} ranks, and none is initialized — start one "
            "process per shard (launch/mesh.py::spawn)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"mesh {dict(zip(axis_names, axis_sizes))} needs {n} ranks, the process "
            f"group has {world} — start one process per shard (launch/mesh.py::spawn)")
    rank = dist.get_rank()
    groups = {}
    for axis, name in enumerate(axis_names):
        for line in _lines(axis_sizes, axis):
            group = dist.new_group(line)
            if rank in line:
                groups[name] = group
    return Mesh(axis_names, axis_sizes, rank, groups)


def data_mesh(n_shards: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D mesh of ``n_shards`` ranks for the sharded replay/learner data
    path (default: every rank of the process group)."""
    n = n_shards or (dist.get_world_size() if dist.is_initialized() else 1)
    return make_mesh((axis,), (n,))


def pod_data_mesh(n_pods: int, n_data: int,
                  axes: Tuple[str, str] = ("pod", "data")) -> Mesh:
    """2-D ``(pod, data)`` mesh for the two-axis sharded executor.  The
    first (outer) axis is the slow inter-pod link that the int8
    error-feedback reduce crosses; the second the fast intra-pod axis.
    Ranks are row-major pod-major, the executor's flattened shard ids, so
    a ``pod_data_mesh(P, 1)`` run reproduces a ``data_mesh(P)`` run
    exactly from the same seed."""
    if n_pods < 1 or n_data < 1:
        raise ValueError(f"pod_data_mesh({n_pods}, {n_data}): both axis "
                         "extents must be ≥ 1")
    return make_mesh(axes, (n_pods, n_data))


def mesh_from_plan(plan) -> Optional[Mesh]:
    """The mesh a ``runtime.planner.PlannedConfig`` selected, over the
    current process group: ``None`` for a plan without one (the fused
    program, also its async form), else ``pod_data_mesh(n_pods, n_data)``
    when the plan has more than one pod and ``data_mesh(n_data)``
    otherwise.  Its world must be ``plan.n_devices`` ranks; with no group
    this raises as ``make_mesh`` does."""
    if not plan.n_data:
        return None
    if plan.n_pods > 1:
        return pod_data_mesh(plan.n_pods, plan.n_data)
    return data_mesh(plan.n_data)


# -- the local launcher ---------------------------------------------------------


def _entry(rank: int, fn: Callable, args: tuple, world: int, backend: str,
           device: str, init_file: str, out_dir: str, timeout_s: float) -> None:
    # the host's cores shared among the ranks, as torchrun does: more
    # intra-op threads than cores makes the ranks spin against each other
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world: int, *args, backend: str, device: str,
          timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` local ranks of a fresh process
    group and return the ranks' return values in rank order.

    ``fn`` and ``args`` must pickle (``fn`` by import path).  Each rank
    joins the group before ``fn`` runs (``init_process_group`` with
    ``timeout_s``) and leaves it after; with a CUDA ``device`` of an index
    each rank sets it as its current device first, and ``cpu_count // world``
    intra-op threads.  One rank's exception ends the
    other ranks and raises here, with that rank's traceback; a world still
    running after ``timeout_s`` is ended and raises ``TimeoutError``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"world={world}: need ≥ 1 rank")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(fn, args, world, backend, device,
                          os.path.join(tmp, "rendezvous"), tmp, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(timeout=10.0)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{world} ranks still running after {timeout_s:.0f} s")
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
