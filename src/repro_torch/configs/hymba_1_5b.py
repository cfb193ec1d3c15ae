"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16, parallel attention + mamba heads; sliding
window attention with 3 global layers (first/middle/last).
[arXiv:2411.13676; hf]  A copy of ``repro.configs.hymba_1_5b``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    attention="sliding",
    window=1024,
    global_layers=(0, 15, 31),   # first / middle / last attend globally
    ssm_state=16,
    hybrid=True,
    ssm_expand=2,
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, window=32, ssm_state=4,
    dtype="float32",
)
