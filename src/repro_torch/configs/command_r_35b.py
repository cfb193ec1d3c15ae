"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]  A copy
of ``repro.configs.command_r_35b``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",          # Cohere uses LayerNorm (no bias folded in)
    rope_theta=8_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="command-r-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
)
