"""Storage-row gather kernel (``csrc/gather.cu``) and its plain version.

Port of the TPU kernel ``repro/kernels/gather.py``: ``out[i] =
storage[idx[i]]`` for storage of any rank and dtype, copied as bytes in
the widest vector the row size and alignment allow.  Indices are clamped
into ``[0, N-1]`` as XLA's gather clamps them.  Bit-exact for every
dtype, including int32 values ≥ 2^24 that the TPU kernel's f32 one-hot
matmul cannot carry.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NAME = "gather"


def gather_plain(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return storage[idx.clamp(0, storage.shape[0] - 1)]


@functools.cache
def _fn():
    fn = _build.load(NAME).gather_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
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


def gather_cuda(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    check_rows(storage, idx)
    b = idx.shape[0]
    out = torch.empty((b,) + tuple(storage.shape[1:]), dtype=storage.dtype,
                      device=storage.device)
    nbytes = row_bytes(storage)
    vec = vector_bytes(nbytes, storage.data_ptr(), out.data_ptr())
    rc = _fn()(storage.data_ptr(), idx.data_ptr(), out.data_ptr(), b,
               storage.shape[0], nbytes, vec, _build.stream_handle(storage.device))
    _build.check(rc, NAME)
    return out
