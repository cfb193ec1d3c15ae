"""Inverse-CDF sample kernel (``csrc/sumtree_sample.cu``) and its plain
version.

Port of the TPU kernel ``repro/kernels/sumtree_sample.py``: one warp per
draw walks the flat tree, loading each K-wide sibling row whole (C =
ceil(K/32) children a lane) and scanning it in registers: sequential sums
in each lane, a warp-shuffle scan of the lane totals, ``__ballot_sync``/
``__ffs`` for the first lane that reaches the residual and a short search
in that lane (``csrc/descend.cuh``).  The total is read from the root
``tree[0]``, as the reference ``sumtree.sample`` does.  The scan sums in
another order than a sequential cumsum, so a sampled index may differ
from the plain version only at an fp tie of the CDF.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import sumtree
from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.kernels import _build

NAME = "sumtree_sample"


def sumtree_sample_plain(spec: SumTreeSpec, tree: torch.Tensor,
                         u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return sumtree.sample(spec, tree, u)


@functools.cache
def _fn():
    fn = _build.load(NAME).sumtree_sample_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_tree(spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor) -> None:
    if tree.device.type != "cuda" or u.device != tree.device:
        raise ValueError(f"tree and u must be on one CUDA device, got "
                         f"{tree.device} and {u.device}")
    if tree.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"tree and u must be float32, got {tree.dtype}, {u.dtype}")
    if tree.shape != (spec.total_size,) or not tree.is_contiguous():
        raise ValueError(f"tree must be contiguous ({spec.total_size},), got "
                         f"{tuple(tree.shape)}")
    if u.dim() != 1 or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous 1-D tensor, got {tuple(u.shape)}")
    if spec.num_leaves >= 2**31:
        raise ValueError("the kernels index leaves with 32-bit groups")


def sumtree_sample_cuda(spec: SumTreeSpec, tree: torch.Tensor,
                        u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    check_tree(spec, tree, u)
    b = u.shape[0]
    idx = torch.empty((b,), dtype=torch.int64, device=tree.device)
    pri = torch.empty((b,), dtype=torch.float32, device=tree.device)
    rc = _fn()(tree.data_ptr(), u.data_ptr(), idx.data_ptr(), pri.data_ptr(),
               b, spec.fanout, spec.capacity, _build.level_offsets(spec),
               len(spec.offsets), _build.stream_handle(tree.device))
    _build.check(rc, NAME)
    return idx, pri
