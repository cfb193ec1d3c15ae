"""whisper-medium [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865; conv frontend is a
STUB (input_specs supplies precomputed frame embeddings).
[arXiv:2212.04356; unverified]  A copy of ``repro.configs.whisper_medium``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    frontend="audio",
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    encoder_seq=32, dtype="float32",
)
