"""Assigned input shapes and their stand-ins (dry-run inputs) — port of
``repro.configs.shapes``.

Shapes (LM family — seq_len × global_batch):
    train_4k      4_096 × 256   → train_step (token-Q learner)
    prefill_32k  32_768 × 32    → prefill (actor episode bootstrap)
    decode_32k   32_768 × 128   → serve_step (1 token, 32k KV cache)
    long_500k   524_288 × 1     → serve_step; sub-quadratic archs only

``token_specs`` and ``learner_batch_specs`` give every model input of an
(arch, shape) cell as {name: (shape, dtype)}, the reference's
``ShapeDtypeStruct``s; ``meta_tensors`` makes them tensors on the meta
device, which hold no storage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}


def runnable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k is skipped for pure-full-attention archs (DESIGN.md §5)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def _modality(cfg: ModelConfig, b: int, s: int) -> Tuple[int, Dict[str, Spec]]:
    """(text length, the frontend stub's embeddings): vlm's patches take
    ``num_patch_tokens`` of the sequence; audio's frames come beside it."""
    if cfg.family == "vlm":
        return s - cfg.num_patch_tokens, {
            "extra_embeds": ((b, cfg.num_patch_tokens, cfg.d_model), torch.bfloat16)}
    if cfg.family == "audio":
        return s, {"extra_embeds": ((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)}
    return s, {}


def token_specs(cfg: ModelConfig, case: ShapeCase) -> Dict[str, Spec]:
    """Model inputs for the given cell (tokens + modality stubs)."""
    b, s = case.global_batch, case.seq_len
    if case.kind == "decode":
        return {"tokens": ((b, 1), torch.int32)}
    s_text, specs = _modality(cfg, b, s)
    specs["tokens"] = ((b, s_text), torch.int32)
    return specs


def learner_batch_specs(cfg: ModelConfig, case: ShapeCase) -> Dict[str, Spec]:
    """Transition minibatch for the token-Q learner train_step:
    tokens/actions/rewards/dones per position + PER importance weights."""
    b = case.global_batch
    s_text, specs = _modality(cfg, b, case.seq_len)
    specs.update(
        tokens=((b, s_text), torch.int32),
        actions=((b, s_text), torch.int32),
        rewards=((b, s_text), torch.float32),
        dones=((b, s_text), torch.float32),
        is_weights=((b,), torch.float32),
    )
    return specs


def meta_tensors(specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """{name: tensor on the meta device} of {name: (shape, dtype)}."""
    return {k: torch.empty(shape, dtype=dtype, device="meta") for k, (shape, dtype) in specs.items()}
