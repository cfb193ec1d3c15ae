"""Fused sample + gather kernel (``csrc/sample_gather.cu``) and its plain
version.

Port of the TPU kernel ``repro/kernels/sample_gather.py``: the warp that
descends for a draw (the descent shared with ``sumtree_sample.cu``
through ``descend.cuh``) copies that draw's row from every storage leaf,
in the leaf's native dtype, through a table of (source, destination,
row bytes, vector width, first chunk).  Its lanes share the chunks of
all the leaves' rows and load them all before storing any, so every
leaf's row is in flight at once.  Returns the same ``(idx, pri)`` as the
split sample kernel and the rows bit-exact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core import sumtree
from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.gather import check_rows, gather_plain, row_bytes, vector_bytes
from repro_torch.kernels.sumtree_sample import check_tree

NAME = "sample_gather"
MAX_LEAVES = 16   # kMaxLeaves in csrc/sample_gather.cu

Storage = Dict[str, torch.Tensor]


def sample_gather_plain(spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor,
                        storage: Storage
                        ) -> Tuple[torch.Tensor, torch.Tensor, Storage]:
    idx, pri = sumtree.sample(spec, tree, u)
    return idx, pri, {k: gather_plain(buf, idx) for k, buf in storage.items()}


@functools.cache
def _fn():
    fn = _build.load(NAME).sample_gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sample_gather_cuda(spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor,
                       storage: Storage
                       ) -> Tuple[torch.Tensor, torch.Tensor, Storage]:
    check_tree(spec, tree, u)
    if len(storage) > MAX_LEAVES:
        raise ValueError(f"at most {MAX_LEAVES} storage leaves, got {len(storage)}")
    b = u.shape[0]
    idx = torch.empty((b,), dtype=torch.int64, device=tree.device)
    pri = torch.empty((b,), dtype=torch.float32, device=tree.device)
    items = {}
    for k, buf in storage.items():
        check_rows(buf, idx)
        items[k] = torch.empty((b,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                               device=buf.device)
    n = len(storage)
    bufs, outs = list(storage.values()), list(items.values())
    rbytes = [row_bytes(buf) for buf in bufs]
    vecs = [vector_bytes(rb, buf.data_ptr(), out.data_ptr())
            for rb, buf, out in zip(rbytes, bufs, outs)]
    rc = _fn()(tree.data_ptr(), u.data_ptr(), idx.data_ptr(), pri.data_ptr(),
               b, spec.fanout, spec.capacity, _build.level_offsets(spec),
               len(spec.offsets), n,
               (ctypes.c_void_p * n)(*[buf.data_ptr() for buf in bufs]),
               (ctypes.c_void_p * n)(*[out.data_ptr() for out in outs]),
               (ctypes.c_longlong * n)(*rbytes),
               (ctypes.c_longlong * n)(*[buf.shape[0] for buf in bufs]),
               (ctypes.c_int * n)(*vecs), _build.stream_handle(tree.device))
    _build.check(rc, NAME)
    return idx, pri, items
