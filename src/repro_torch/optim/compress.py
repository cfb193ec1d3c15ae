"""int8 error-feedback gradient compression for the cross-pod reduce —
port of ``repro.optim.compress``.

Within a pod, gradients reduce in f32 (or bf16) over the fast axis;
across pods each leaf is quantized to int8 with a per-leaf scale and the
quantization error is fed back into the next step (EF-SGD, Karimireddy et
al. 2019), so compression noise does not bias convergence.  The error
buffer is explicit state, a list of f32 tensors shaped like the gradient
list:

    comp, err = compress(grads, err)        # int8 payload + new error
    grads_hat = decompress(comp)            # dequantize after the reduce

``compressed_pmean`` is a **mean** of the dequantized values over the pod
axis: ``pmean(data) → compressed_pmean(pod)`` equals the global pmean up
to quantization error, so the effective learning rate never depends on the
pod count (a caller that needs the weighted *sum* across pods multiplies
by the pod count).  ``torch.round`` and ``jnp.round`` both round half to
even, so ``q`` is the reference's on the same f32 input.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.optim.collectives import fused_tree_reduce

Leaves = List[torch.Tensor]


class CompressedLeaf(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # f32 per-leaf scale


def init_error(params: Sequence[torch.Tensor]) -> Leaves:
    """A zero error buffer shaped like ``params`` (a gradient list)."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def _one(g: torch.Tensor, e: torch.Tensor) -> Tuple[CompressedLeaf, torch.Tensor]:
    gf = g.to(torch.float32) + e
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return CompressedLeaf(q, scale), gf - deq


def compress(grads: Sequence[torch.Tensor], err: Sequence[torch.Tensor]
             ) -> Tuple[List[CompressedLeaf], Leaves]:
    """Quantize each leaf of ``grads + err`` to int8 → (payload, the new
    error ``grads + err - dequantized``)."""
    grads, err = list(grads), list(err)
    if len(grads) != len(err):
        raise ValueError(
            f"error-feedback buffer has {len(err)} leaves but the "
            f"gradient pytree has {len(grads)} — initialize it with "
            "init_error(<gradient-shaped pytree>)")
    pairs = [_one(g, e) for g, e in zip(grads, err)]
    return [c for c, _ in pairs], [e for _, e in pairs]


def decompress(comp: Sequence[CompressedLeaf]) -> Leaves:
    return [c.q.to(torch.float32) * c.scale for c in comp]


def l2_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a list of tensors — the ``compress_error_norm``
    loop metric (the int8 leg's EF residual, or the bf16 cast error)."""
    leaves = list(leaves)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def payload_bytes(comp: Sequence[CompressedLeaf]) -> int:
    """Wire bytes of the compressed payload: one int8 per element plus one
    f32 scale per leaf."""
    return sum(c.q.numel() * c.q.element_size() + c.scale.numel() * 4 for c in comp)


def raw_bytes(leaves: Sequence[torch.Tensor]) -> int:
    """Bytes of the same leaves reduced uncompressed (f32 on the wire)."""
    return sum(x.numel() * 4 for x in leaves)


def compressed_pmean(grads: Sequence[torch.Tensor], err: Sequence[torch.Tensor],
                     axis_name: str, mesh) -> Tuple[Leaves, Leaves]:
    """EF-int8 all-reduce **mean** over ``axis_name`` of ``mesh``: quantize
    this shard's contribution (folding in the carried error), average the
    dequantized values across the axis, return (mean, new error buffer).

    Mean semantics are load-bearing: over P pods of identical inputs it
    returns those inputs up to quantization, as ``pmean`` does.  The
    dequantized f32 payload crosses the axis as one fused collective."""
    comp, new_err = compress(grads, err)
    return fused_tree_reduce(decompress(comp), (axis_name,), mesh, op="mean"), new_err
