"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]  A copy
of ``repro.configs.qwen1_5_32b``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, dtype="float32",
)
