"""Flash-attention kernels — two forwards (``csrc/flash_attention_fwd_sm90.cu``,
wgmma and TMA, for bf16 at hd 64/96/128; ``csrc/flash_attention_fwd.cu``
for f32 and hd 16) and two backward pairs of dQ and dK/dV
(``csrc/flash_attention_dq_sm90.cu`` and ``csrc/flash_attention_dkv_sm90.cu``,
wgmma and TMA, for bf16 at hd 64/96/128; ``csrc/flash_attention_dq.cu`` and
``csrc/flash_attention_dkv.cu`` for f32 and hd 16).  The three kernels of
f32 and hd 16 run warp-level ``mma.sync`` on the tensor cores with
``cp.async`` double buffering — 3xTF32 for f32, bf16 for bf16 — and share
``csrc/flash_mma.cuh``.  With them, their plain versions and the
``torch.autograd.Function`` that ties them together.
``_fwd_kernel_for`` and ``_bwd_kernel_for`` pick the kernels from the dtype
and the head width alone.

Port of the TPU kernels of ``repro/kernels/flash_attention.py``: ``_fwd``
(fused attention on (N, S, hd) tensors, N = batch·heads, with an online
softmax, returning O in the inputs' dtype and the row log-sum-exp (N, S)
in f32) and ``_bwd``'s ``_dq_kernel`` and ``_dkv_kernel``.  Masks:
causal, sliding-window and chunked-local, each lifted by the per-call
``is_global`` flag, exactly as ``_block_mask``; key tiles that no query
of a tile can reach are skipped, as ``_block_reachable``.  The kernels
take any S (the TPU kernels need S divisible by their block) and hd in
{16, 64, 96, 128}.

``FlashAttention`` is the reference's ``_flash`` custom_vjp: the forward
saves q, k, v, O and the LSE; the backward computes
``delta = rowsum(O·dO)`` in f32 as a plain op, as the reference does
outside its kernels, and launches dQ and dK/dV (on CPU tensors: their
plain version).  On meta tensors (the dry run, ``launch/dryrun.py``) the
forward and the backward are stand-ins that return their outputs' shapes
and compute nothing, the counterpart of the reference's
``REPRO_FLASH_STUB``: chosen by the device alone, so a CUDA tensor never
takes them and a failed build or launch still raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

NAME = "flash_attention_fwd"
SM90_NAME = "flash_attention_fwd_sm90"
DQ_NAME = "flash_attention_dq"
DKV_NAME = "flash_attention_dkv"
DQ_SM90_NAME = "flash_attention_dq_sm90"
DKV_SM90_NAME = "flash_attention_dkv_sm90"
NEG = -1e30
ATTENTION = {"full": 0, "sliding": 1, "chunked": 2}
HEAD_DIMS = (16, 64, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM90_HEAD_DIMS = (64, 96, 128)     # the Hopper kernels' (bf16 only)


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


def _bwd_terms(q, k, v, do, lse, delta, attention, window, causal, is_global
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two kernels' shared terms in f32 (N, S, Sk):
    ``p = where(mask, exp(q·kᵀ·scale − lse), 0)`` and
    ``ds = p·(dO·vᵀ − delta)``."""
    s, hd = q.shape[1], q.shape[2]
    mask = attention_mask(torch.arange(s, device=q.device),
                          torch.arange(k.shape[1], device=q.device),
                          attention, window, causal, is_global)
    scores = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    p = torch.where(mask[None], torch.exp(scores - lse[..., None]), torch.zeros_like(scores))
    ds = p * (torch.einsum("nqd,nkd->nqk", do.float(), v.float()) - delta[..., None])
    return p, ds


def _dq(ds, q, k) -> torch.Tensor:
    return (torch.einsum("nqk,nkd->nqd", ds, k.float()) * (1.0 / math.sqrt(q.shape[2]))
            ).to(q.dtype)


def _dkv(p, ds, q, k, v, do) -> Tuple[torch.Tensor, torch.Tensor]:
    dv = torch.einsum("nqk,nqd->nkd", p, do.float())
    dk = torch.einsum("nqk,nqd->nkd", ds, q.float()) * (1.0 / math.sqrt(q.shape[2]))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(q, k, v, do, lse, delta, attention="full", window=0,
                             causal=True, is_global=True) -> torch.Tensor:
    """``_dq_kernel``'s formulas in f32 → dQ in q's dtype:
    ``dq = ds·k·scale``."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, attention, window, causal, is_global)
    return _dq(ds, q, k)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, attention="full", window=0,
                              causal=True, is_global=True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_dkv_kernel``'s formulas in f32 → (dK, dV) in k's dtype:
    ``dv = pᵀ·dO``, ``dk = dsᵀ·q·scale``."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, attention, window, causal, is_global)
    return _dkv(p, ds, q, k, v, do)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              attention: str = "full", window: int = 0,
                              causal: bool = True, is_global: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's plain version → (dQ, dK, dV): delta, then the
    formulas of the two kernels, ``p = where(mask, exp(s·scale − lse), 0)``,
    ``dv = pᵀ·dO``, ``ds = p·(dO·vᵀ − delta)``, ``dq = ds·k·scale``,
    ``dk = dsᵀ·q·scale``, with p and ds computed once."""
    p, ds = _bwd_terms(q, k, v, do, lse, flash_delta(o, do), attention, window, causal,
                       is_global)
    return (_dq(ds, q, k), *_dkv(p, ds, q, k, v, do))


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(O·dO)`` in f32 (N, S): the plain op the reference's
    ``_bwd`` runs outside its kernels."""
    return (o.float() * do.float()).sum(-1)


def _lib_fn(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return _lib_fn(NAME, 5, 9)


@functools.cache
def _sm90_fn():
    return _lib_fn(SM90_NAME, 5, 8)


@functools.cache
def _dq_fn():
    return _lib_fn(DQ_NAME, 7, 9)


@functools.cache
def _dkv_fn():
    return _lib_fn(DKV_NAME, 8, 9)


@functools.cache
def _dq_sm90_fn():
    return _lib_fn(DQ_SM90_NAME, 7, 8)


@functools.cache
def _dkv_sm90_fn():
    return _lib_fn(DKV_SM90_NAME, 8, 8)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 attention: str, window: int) -> None:
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


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                     lse: torch.Tensor, do: torch.Tensor, attention: str, window: int) -> None:
    check_inputs(q, k, v, attention, window)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (N, S) f32, got {tuple(lse.shape)} {lse.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (o, lse, do)):
        raise ValueError("o, lse and do must be contiguous and 16-byte aligned")


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"inputs must be on one CUDA device, got "
                         f"{', '.join(str(t.device) for t in ts)}")
    if ts[0].shape[0] >= 65536:
        raise ValueError(f"N = {ts[0].shape[0]} exceeds the grid's y extent")


def _fwd_kernel_for(dtype: torch.dtype, hd: int) -> str:
    """The forward kernel for inputs of ``dtype`` at head width ``hd``: the
    Hopper kernel (wgmma, bf16 only) for bf16 at hd 64, 96 or 128, the
    ``mma.sync`` tensor-core kernel (3xTF32 in f32) for the rest (f32, and
    hd 16)."""
    return SM90_NAME if dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS else NAME


def _bwd_kernel_for(dtype: torch.dtype, hd: int) -> Tuple[str, str]:
    """The (dQ, dK/dV) kernels for inputs of ``dtype`` at head width ``hd``:
    the Hopper pair (wgmma, bf16 only) for bf16 at hd 64, 96 or 128, the
    ``mma.sync`` tensor-core pair (3xTF32 in f32) for the rest (f32, and
    hd 16)."""
    if dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS:
        return DQ_SM90_NAME, DKV_SM90_NAME
    return DQ_NAME, DKV_NAME


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention: str = "full", window: int = 0,
                         causal: bool = True, is_global: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel that ``_fwd_kernel_for`` picks → (O, LSE)."""
    if _fwd_kernel_for(q.dtype, q.shape[-1]) == SM90_NAME:
        return flash_attention_sm90_cuda(q, k, v, attention, window, causal, is_global)
    check_inputs(q, k, v, attention, window)
    _check_cuda(q, k, v)
    n, s, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((n, s), dtype=torch.float32, device=q.device)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), n, s, k.shape[1], hd,
               *_mask_args(q, attention, window, causal, is_global))
    _build.check(rc, NAME)
    return o, lse


def flash_attention_sm90_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              attention: str = "full", window: int = 0,
                              causal: bool = True, is_global: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper forward kernel → (O, LSE)."""
    check_inputs(q, k, v, attention, window)
    _check_cuda(q, k, v)
    n, s, hd = q.shape
    if q.dtype != torch.bfloat16 or hd not in SM90_HEAD_DIMS:
        raise ValueError(f"{SM90_NAME} takes bf16 at hd {SM90_HEAD_DIMS}, got {q.dtype}, "
                         f"hd {hd}")
    o = torch.empty_like(q)
    lse = torch.empty((n, s), dtype=torch.float32, device=q.device)
    rc = _sm90_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    n, s, k.shape[1], hd, ATTENTION[attention], int(window),
                    int(bool(causal)), int(bool(is_global)), _build.stream_handle(q.device))
    _build.check(rc, SM90_NAME)
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attention: str = "full", window: int = 0,
                        causal: bool = True, is_global: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (O, LSE).  The plain version for CPU tensors, and only then; on
    meta tensors the shapes alone; on CUDA the kernel or an error."""
    if q.device.type in ("cpu", "meta"):
        check_inputs(q, k, v, attention, window)
        if q.device.type == "meta":
            return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)
        return flash_attention_plain(q, k, v, attention, window, causal, is_global)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return flash_attention_cuda(q, k, v, attention, window, causal, is_global)


def _mask_args(q: torch.Tensor, attention: str, window: int, causal: bool,
               is_global: bool) -> tuple:
    return (DTYPES[q.dtype], ATTENTION[attention], int(window), int(bool(causal)),
            int(bool(is_global)), _build.stream_handle(q.device))


def flash_attention_dq_cuda(q, k, v, do, lse, delta, attention="full", window=0,
                            causal=True, is_global=True) -> torch.Tensor:
    """The dQ kernel → dQ.  The caller has checked the inputs
    (``flash_attention_bwd_cuda``)."""
    n, s, hd = q.shape
    dq = torch.empty_like(q)
    rc = _dq_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), n, s, k.shape[1], hd,
                  *_mask_args(q, attention, window, causal, is_global))
    _build.check(rc, DQ_NAME)
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, attention="full", window=0,
                             causal=True, is_global=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel → (dK, dV).  The caller has checked the inputs."""
    n, s, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _dkv_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, s, k.shape[1], hd,
                   *_mask_args(q, attention, window, causal, is_global))
    _build.check(rc, DKV_NAME)
    return dk, dv


def _check_sm90(name: str, q: torch.Tensor, *ts: torch.Tensor) -> None:
    _check_cuda(q, *ts)
    if q.dtype != torch.bfloat16 or q.shape[2] not in SM90_HEAD_DIMS:
        raise ValueError(f"{name} takes bf16 at hd {SM90_HEAD_DIMS}, got {q.dtype}, "
                         f"hd {q.shape[2]}")


def flash_attention_dq_sm90_cuda(q, k, v, do, lse, delta, attention="full", window=0,
                                 causal=True, is_global=True) -> torch.Tensor:
    """The Hopper dQ kernel → dQ.  The caller has checked the shapes
    (``flash_attention_bwd_cuda``)."""
    _check_sm90(DQ_SM90_NAME, q, k, v, do, lse, delta)
    n, s, hd = q.shape
    dq = torch.empty_like(q)
    rc = _dq_sm90_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, s, k.shape[1], hd,
                       *_mask_args(q, attention, window, causal, is_global)[1:])
    _build.check(rc, DQ_SM90_NAME)
    return dq


def flash_attention_dkv_sm90_cuda(q, k, v, do, lse, delta, attention="full", window=0,
                                  causal=True, is_global=True
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper dK/dV kernel → (dK, dV).  The caller has checked the
    shapes."""
    _check_sm90(DKV_SM90_NAME, q, k, v, do, lse, delta)
    n, s, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _dkv_sm90_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, s,
                        k.shape[1], hd, *_mask_args(q, attention, window, causal, is_global)[1:])
    _build.check(rc, DKV_SM90_NAME)
    return dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             attention: str = "full", window: int = 0,
                             causal: bool = True, is_global: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """delta (a plain op), then the dQ and the dK/dV kernels that
    ``_bwd_kernel_for`` picks → (dQ, dK, dV)."""
    check_bwd_inputs(q, k, v, o, lse, do, attention, window)
    _check_cuda(q, k, v, o, lse, do)
    delta = flash_delta(o, do)
    mask = (attention, window, causal, is_global)
    if _bwd_kernel_for(q.dtype, q.shape[2])[0] == DQ_SM90_NAME:
        return (flash_attention_dq_sm90_cuda(q, k, v, do, lse, delta, *mask),
                *flash_attention_dkv_sm90_cuda(q, k, v, do, lse, delta, *mask))
    return (flash_attention_dq_cuda(q, k, v, do, lse, delta, *mask),
            *flash_attention_dkv_cuda(q, k, v, do, lse, delta, *mask))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        attention: str = "full", window: int = 0,
                        causal: bool = True, is_global: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (dQ, dK, dV).  The plain version for CPU tensors, and only then;
    on meta tensors the shapes alone; on CUDA the two kernels or an
    error."""
    if q.device.type in ("cpu", "meta"):
        check_bwd_inputs(q, k, v, o, lse, do, attention, window)
        if q.device.type == "meta":
            return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        return flash_attention_bwd_plain(q, k, v, o, lse, do, attention, window, causal,
                                         is_global)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return flash_attention_bwd_cuda(q, k, v, o, lse, do, attention, window, causal, is_global)


class FlashAttention(torch.autograd.Function):
    """O = flash attention of (q, k, v), differentiable in all three: the
    reference's ``_flash`` custom_vjp.  The gradient that reaches the
    backward may be a strided view (the model's head transpose, or
    ``sum()``'s expanded ones); it is made contiguous here, since the
    kernels take nothing else."""

    @staticmethod
    def forward(ctx, q, k, v, attention, window, causal, is_global):
        o, lse = flash_attention_fwd(q, k, v, attention, window, causal, is_global)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (attention, window, causal, is_global)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None, None
