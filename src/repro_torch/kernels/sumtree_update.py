"""Priority-update kernel (``csrc/sumtree_update.cu``) and its plain
version.

Port of the TPU kernel ``repro/kernels/sumtree_update.py``: a batched
priority SET that writes each surviving leaf and ``atomicAdd``s its
delta into every ancestor and the root, in place in the flat tree.  The
last-writer mask is computed outside the kernel (the port's
``sumtree.last_writer_mask``), or skipped when the indices are unique.
Float atomics sum in a varying order, so the kernel is held to the plain
version with allclose, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import sumtree
from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.kernels import _build

NAME = "sumtree_update"


def sumtree_update_plain(spec: SumTreeSpec, tree: torch.Tensor,
                         idx: torch.Tensor, values: torch.Tensor,
                         unique: bool = False) -> torch.Tensor:
    return sumtree.update(spec, tree, idx, values, unique=unique)


@functools.cache
def _fn():
    fn = _build.load(NAME).sumtree_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sumtree_update_cuda(spec: SumTreeSpec, tree: torch.Tensor,
                        idx: torch.Tensor, values: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """In-place SET of ``tree``; ``mask`` (bool, one per update) marks the
    surviving writes, ``None`` means every index is distinct."""
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
    mask_ptr = None
    if mask is not None:
        if mask.shape != (b,) or mask.device != tree.device:
            raise ValueError("mask must be (B,) on the tree's device")
        mask = mask.to(torch.uint8).contiguous()
        mask_ptr = mask.data_ptr()
    rc = _fn()(tree.data_ptr(), idx.data_ptr(), values.data_ptr(), mask_ptr, b,
               spec.fanout, _build.level_offsets(spec), len(spec.offsets),
               _build.stream_handle(tree.device))
    _build.check(rc, NAME)
    return tree
