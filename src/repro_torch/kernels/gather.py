"""Storage-row gather kernel (``csrc/gather.cu``) and its plain version.

Port of the TPU kernel ``repro/kernels/gather.py``: ``out[i] =
storage[idx[i]]`` for storage of any rank and dtype, copied as bytes in
the widest vector the row size and alignment allow.  One launch gathers
every leaf of a storage dict (at most 16), through a table of (source,
destination, row bytes, rows, vector width); a single tensor is a
one-entry table.  Indices are clamped into each leaf's ``[0, N-1]`` as
XLA's gather clamps them.  Bit-exact for every dtype, including int32
values ≥ 2^24 that the TPU kernel's f32 one-hot matmul cannot carry, and
inf and NaN, which that matmul spreads into every gathered row.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from repro_torch.kernels import _build

NAME = "gather"
MAX_LEAVES = 16   # kMaxLeaves in csrc/gather.cu

Storage = Dict[str, torch.Tensor]


def gather_plain(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return storage[idx.clamp(0, storage.shape[0] - 1)]


def gather_items_plain(storage: Storage, idx: torch.Tensor) -> Storage:
    return {k: gather_plain(buf, idx) for k, buf in storage.items()}


@functools.cache
def _fn():
    fn = _build.load(NAME).gather_items_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_bytes(buf: torch.Tensor) -> int:
    return math.prod(buf.shape[1:]) * buf.element_size()


def vector_bytes(nbytes: int, *ptrs: int) -> int:
    """Widest copy vector dividing the row size and every pointer."""
    for v in (16, 8, 4, 2):
        if nbytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def check_rows(storage: torch.Tensor, idx: torch.Tensor) -> None:
    if storage.device.type != "cuda" or idx.device != storage.device:
        raise ValueError(f"storage and idx must be on one CUDA device, got "
                         f"{storage.device} and {idx.device}")
    if storage.dim() < 1 or storage.shape[0] < 1 or not storage.is_contiguous():
        raise ValueError("storage must be contiguous with at least one row, "
                         f"got {tuple(storage.shape)}")
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous 1-D int64 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def gather_items_cuda(storage: Storage, idx: torch.Tensor) -> Storage:
    if not 1 <= len(storage) <= MAX_LEAVES:
        raise ValueError(f"1 to {MAX_LEAVES} storage leaves a launch, got {len(storage)}")
    b = idx.shape[0]
    items = {}
    for k, buf in storage.items():
        check_rows(buf, idx)
        items[k] = torch.empty((b,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                               device=buf.device)
    bufs, outs = list(storage.values()), list(items.values())
    rbytes = [row_bytes(buf) for buf in bufs]
    if b == 0 or not any(rbytes):
        return items            # nothing to copy: no launch
    n = len(bufs)
    vecs = [vector_bytes(rb, buf.data_ptr(), out.data_ptr())
            for rb, buf, out in zip(rbytes, bufs, outs)]
    rc = _fn()(idx.data_ptr(), b, n,
               (ctypes.c_void_p * n)(*[buf.data_ptr() for buf in bufs]),
               (ctypes.c_void_p * n)(*[out.data_ptr() for out in outs]),
               (ctypes.c_longlong * n)(*rbytes),
               (ctypes.c_longlong * n)(*[buf.shape[0] for buf in bufs]),
               (ctypes.c_int * n)(*vecs), _build.stream_handle(idx.device))
    _build.check(rc, NAME)
    return items


def gather_cuda(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return gather_items_cuda({"rows": storage}, idx)["rows"]
