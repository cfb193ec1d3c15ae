"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (per expert), vocab=202048, MoE 128 experts top-1 + shared
expert, alternating dense/MoE layers, chunked-local attention (8192)
with periodic global (RoPE-free "NoPE") layers.
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]  A copy
of ``repro.configs.llama4_maverick_400b_a17b``.  As in the reference's
code, the global layers rotate like the others (``use_rope`` is off for
the audio family only), and a unit's two attention sub-layers share one
set of weights (``models/backbone.py``)."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    attention="chunked",
    window=8192,
    global_layer_period=4,     # every 4th layer attends globally
    num_experts=128,
    experts_per_token=1,
    moe_layer_period=2,        # interleaved dense / MoE
    num_shared_experts=1,
    rope_theta=500_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, num_experts=4,
    experts_per_token=1, window=32, global_layer_period=2, dtype="float32",
)
