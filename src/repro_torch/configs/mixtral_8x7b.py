"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]  A copy
of ``repro.configs.mixtral_8x7b``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attention="sliding",
    window=4096,
    num_experts=8,
    experts_per_token=2,
    moe_layer_period=1,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, num_experts=4,
    experts_per_token=2, window=32, dtype="float32",
)
