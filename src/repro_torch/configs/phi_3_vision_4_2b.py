"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP vision stub (input_specs supplies
576 precomputed patch embeddings prepended to the text).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]  A copy
of ``repro.configs.phi_3_vision_4_2b``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    num_patch_tokens=576,     # CLIP ViT-L/14 @ 336px → 24×24 patches
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3v-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, num_patch_tokens=8,
    dtype="float32",
)
