"""xlstm-125m [ssm] — 12 blocks, d_model=768, 4 heads, vocab=50304,
attention-free: mLSTM blocks with sLSTM blocks interleaved (positions
1 and 7, the paper's 7:1-style mix).  d_ff=0 in the assignment — block
MLPs use the xLSTM projection factors (mLSTM 2×, sLSTM 4/3×).
[arXiv:2405.04517; unverified]  A copy of ``repro.configs.xlstm_125m``."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_at=(1, 7),
    scan_layers=False,        # heterogeneous blocks → unrolled
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", num_layers=3, d_model=64, num_heads=2,
    num_kv_heads=2, vocab_size=256, slstm_at=(1,), dtype="float32",
)
