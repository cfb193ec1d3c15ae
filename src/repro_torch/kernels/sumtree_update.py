"""Priority-update kernel (``csrc/sumtree_update.cu``) and its plain
version.

Port of the TPU kernel ``repro/kernels/sumtree_update.py``: a batched
priority SET, in place in the flat tree.  One launch a chunk of up to
``CHUNK`` updates does the last-writer dedup itself (a sort of
(index, position) keys in the CTA), writes each surviving leaf and adds
every ancestor's run of deltas with one plain store per node (segmented
scans, no atomics), so the same inputs give the same tree bit for bit.
A larger batch runs as chunks in position order, one launch each.  The
plain version, ``core/sumtree.py::update``, keeps ``last_writer_mask``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import sumtree
from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.kernels import _build

NAME = "sumtree_update"
CHUNK = 1024   # kChunk in csrc/sumtree_update.cu: updates a launch


def sumtree_update_plain(spec: SumTreeSpec, tree: torch.Tensor,
                         idx: torch.Tensor, values: torch.Tensor,
                         unique: bool = False) -> torch.Tensor:
    return sumtree.update(spec, tree, idx, values, unique=unique)


@functools.cache
def _fn():
    fn = _build.load(NAME).sumtree_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def sumtree_update_cuda(spec: SumTreeSpec, tree: torch.Tensor,
                        idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """In-place SET of ``tree``, duplicates last-writer-wins (resolved in
    the kernel, so distinct indices need no flag): ceil(B / CHUNK)
    launches.  Indices must lie in [0, num_leaves)."""
    if tree.device.type != "cuda" or idx.device != tree.device:
        raise ValueError(f"tree and idx must be on one CUDA device, got "
                         f"{tree.device} and {idx.device}")
    if tree.dtype != torch.float32 or tree.shape != (spec.total_size,) \
            or not tree.is_contiguous():
        raise ValueError("tree must be a contiguous float32 "
                         f"({spec.total_size},) tensor")
    if spec.num_leaves >= 2**31:
        raise ValueError("the kernels index leaves with 32-bit groups")
    b = idx.shape[0]
    idx = idx.to(torch.int64).contiguous()
    values = values.to(device=tree.device, dtype=torch.float32).contiguous()
    if values.shape != (b,) or idx.dim() != 1:
        raise ValueError(f"idx and values must be (B,), got {tuple(idx.shape)} "
                         f"and {tuple(values.shape)}")
    launches = ctypes.c_int(0)
    rc = _fn()(tree.data_ptr(), idx.data_ptr(), values.data_ptr(), b, spec.fanout,
               _build.level_offsets(spec), len(spec.offsets),
               _build.stream_handle(tree.device), ctypes.byref(launches))
    _build.check(rc, NAME, launches.value)
    return tree
