"""Flash-attention forward kernel (``csrc/flash_attention_fwd.cu``) and its
plain version.

Port of the TPU kernel ``repro/kernels/flash_attention.py`` ``_fwd``:
fused attention on (N, S, hd) tensors (N = batch·heads) with an online
softmax, returning O in the inputs' dtype and the row log-sum-exp (N, S)
in f32.  Masks: causal, sliding-window and chunked-local, each lifted by
the per-call ``is_global`` flag, exactly as ``_block_mask``; key tiles
that no query of a tile can reach are skipped, as ``_block_reachable``.
The kernel takes any S (the TPU kernel needs S divisible by its block)
and hd in {16, 64, 96, 128}.

Forward only: the backward kernels (dQ, dK/dV) are not ported yet, so
the wrapper raises on inputs that require grad rather than drop a
gradient.  The dry-run stand-in ``REPRO_FLASH_STUB`` is not ported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

NAME = "flash_attention_fwd"
NEG = -1e30
ATTENTION = {"full": 0, "sliding": 1, "chunked": 2}
HEAD_DIMS = (16, 64, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, attention: str,
                   window: int, causal: bool, is_global: bool) -> torch.Tensor:
    """(Sq, Sk) bool: ``_block_mask`` of the TPU kernel (``window`` is
    read by the sliding and chunked masks only)."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kp <= qp
    if attention == "sliding" and not is_global:
        mask &= kp > qp - window
    if attention == "chunked" and not is_global:
        mask &= torch.div(kp, window, rounding_mode="floor") == torch.div(
            qp, window, rounding_mode="floor")
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          attention: str = "full", window: int = 0,
                          causal: bool = True, is_global: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle ``repro.kernels.ref.flash_attention_ref`` with the row
    LSE added → (O in q's dtype, LSE f32)."""
    s, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scores = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) / math.sqrt(hd)
    mask = attention_mask(torch.arange(s, device=q.device),
                          torch.arange(sk, device=q.device),
                          attention, window, causal, is_global)
    scores = torch.where(mask[None], scores, torch.full_like(scores, NEG))
    lse = torch.logsumexp(scores, dim=-1)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("nqk,nkd->nqd", w, v.float()).to(q.dtype)
    return out, lse


@functools.cache
def _fn():
    fn = _build.load(NAME).flash_attention_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 attention: str, window: int) -> None:
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash attention has no backward kernel yet: call it "
                           "on tensors that do not require grad (torch.no_grad())")
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {tuple(ATTENTION)}, got {attention!r}")
    if attention == "chunked" and window < 1:
        raise ValueError(f"chunked attention needs window >= 1, got {window}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be (N, S, hd) with k and v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    # what the kernel takes, checked on every device so that the CPU
    # tests refuse what the card would
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in f32/bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention: str = "full", window: int = 0,
                         causal: bool = True, is_global: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_inputs(q, k, v, attention, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must be on one CUDA device, got {q.device}, "
                         f"{k.device}, {v.device}")
    n, s, hd = q.shape
    if n >= 65536:
        raise ValueError(f"N = {n} exceeds the grid's y extent")
    o = torch.empty_like(q)
    lse = torch.empty((n, s), dtype=torch.float32, device=q.device)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), n, s, k.shape[1], hd, DTYPES[q.dtype],
               ATTENTION[attention], int(window), int(bool(causal)),
               int(bool(is_global)), _build.stream_handle(q.device))
    _build.check(rc, NAME)
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attention: str = "full", window: int = 0,
                        causal: bool = True, is_global: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (O, LSE).  The plain version for CPU tensors, and only then; on
    CUDA the kernel or an error."""
    if q.device.type == "cpu":
        check_inputs(q, k, v, attention, window)
        return flash_attention_plain(q, k, v, attention, window, causal, is_global)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return flash_attention_cuda(q, k, v, attention, window, causal, is_global)
