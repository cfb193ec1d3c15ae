"""Model and sharding configuration — a copy of
``repro.models.config``'s ``ShardingConfig``, ``NO_SHARDING`` and
``ModelConfig`` with every field and property, so the port imports
nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh-axis roles.  ``fsdp`` axes shard params+batch; ``tp`` shards
    heads/d_ff/vocab/experts (the 'model' axis)."""

    fsdp: Tuple[str, ...] = ("data",)
    tp: Optional[str] = "model"
    tp_extent: int = 16          # production model-axis size (spec choices)
    dp_extent: int = 16          # total data-axes extent (local dispatch)
    enabled: bool = True

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.fsdp


NO_SHARDING = ShardingConfig(fsdp=(), tp=None, enabled=False)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | audio | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads
    qkv_bias: bool = False
    # attention variant
    attention: str = "full"          # full | sliding | chunked
    window: int = 4096
    global_layer_period: int = 0     # every p-th layer uses full attention
    global_layers: Tuple[int, ...] = ()  # explicit global layer indices
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1        # every p-th layer is MoE (1 = all)
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid (Hymba: parallel attention + mamba heads)
    ssm_state: int = 0
    hybrid: bool = False
    ssm_expand: int = 2              # d_inner = ssm_expand * d_model
    # xLSTM
    slstm_at: Tuple[int, ...] = ()   # layer indices using sLSTM blocks
    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # stub frame count (30 s @ 50 Hz)
    # modality frontend stubs (input_specs supplies embeddings)
    frontend: str = "none"           # none | audio | vision
    num_patch_tokens: int = 0        # vision tokens prepended to the text
    # numerics / structure
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"
    # attention implementation (§Perf): 'naive' materializes (…,S,S)
    # scores (paper-faithful baseline); 'chunked_q' scans query chunks
    # with exact row softmax — no S² residency (beyond-paper optimized)
    attn_impl: str = "naive"
    attn_q_chunk: int = 512
    seq_shard_residual: bool = False  # Megatron-SP-style residual sharding
    # §Perf (mixtral): when num_experts doesn't divide the model axis,
    # shard expert d_ff instead of (padded) experts — baseline keeps the
    # padded-EP layout for comparability
    moe_ff_tp_fallback: bool = False
    # §Perf (xlstm): chunkwise-parallel mLSTM training path (per-chunk
    # state storage instead of per-step) — baseline keeps the exact
    # sequential scan
    mlstm_chunked: bool = False
    # §Perf (mixtral): per-data-shard MoE dispatch — token ranks and
    # capacity are computed within each shard, so the (E, C, d) expert
    # buffers shard over data with no cross-shard collectives (standard
    # distributed-MoE semantics; per-shard token dropping)
    moe_local_dispatch: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # decode-time cache sharding: "heads" when kv_heads % tp == 0, else "seq"
    cache_shard: str = "auto"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token context is tractable (DESIGN.md §5).
        Hymba's few global layers are fine: decode cost is linear in the
        cache and only 3 layers keep full history."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention == "sliding" and self.global_layer_period == 0

    def layer_is_moe(self, layer: int) -> bool:
        if self.num_experts == 0:
            return False
        return (layer + 1) % self.moe_layer_period == 0

    def layer_is_global_attn(self, layer: int) -> bool:
        if self.attention == "full":
            return True
        if layer in self.global_layers:
            return True
        if self.global_layer_period == 0:
            return False
        return (layer + 1) % self.global_layer_period == 0
