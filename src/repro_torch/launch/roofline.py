"""Roofline terms of a dry-run cell — the counterpart of
``repro.launch.hlo_analysis``.  The reference reads its terms from XLA's
compiled HLO; the port has no HLO, so it keeps no HLO parser: the dry run
(``launch/dryrun.py``) counts the FLOPs of an unsharded probe under
``FlopCounterMode`` and records every op and collective of the sharded
run on a fake process group, and this module turns those counts into
seconds on an NVIDIA H100 SXM:

    compute    = FLOPs / (chips × 989 TFLOP/s bf16 dense)
    memory     = bytes / (chips × 3.35 TB/s HBM3)
    collective = wire bytes a device / link bandwidth

The collectives' wire bytes a device take the reference's ring factors,
with n the size of the collective's group:

    all-gather       (n-1)/n × out_bytes
    reduce-scatter   (n-1)   × out_bytes        (= (n-1)/n × in)
    all-reduce       2(n-1)/n × bytes
    all-to-all       (n-1)/n × bytes
    collective-permute  1 × bytes

Constants: the H100 SXM data sheet's dense bf16 rate and HBM3 bandwidth.
The link: a 16-wide mesh axis spans two 8-GPU NVLink nodes (a DGX H100
holds eight), so every ring of the production meshes (16×16, 2×16×16)
crosses the inter-node network, where each GPU has its own 400 Gb/s
ConnectX-7 NDR port (DGX H100 reference architecture): a ring step runs
at that port's rate, 50 GB/s each way, however fast the NVLink hops inside
a node are (450 GB/s each way).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PEAK_FLOPS = 989e12            # bf16 dense, FLOP/s per H100 SXM
HBM_BW = 3.35e12               # bytes/s per H100 SXM (HBM3)
NDR_BITS_PER_S = 400e9         # one ConnectX-7 NDR port per GPU
LINK_BW = NDR_BITS_PER_S / 8   # bytes/s each way: the inter-node hop bounds the ring


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, float]
    wire_bytes: float                 # per device, ring-factored
    raw_bytes: Dict[str, float]       # per op kind, unfactored output bytes


def wire_bytes(op: str, bytes_out: float, n: int) -> float:
    """Bytes one device sends for a collective of output ``bytes_out``
    over a group of ``n`` (the module docstring's ring factors)."""
    n = max(n, 2)
    if op == "all-gather":
        return bytes_out * (n - 1) / n
    if op == "reduce-scatter":
        return bytes_out * (n - 1)
    if op == "all-reduce":
        return 2 * bytes_out * (n - 1) / n
    if op == "all-to-all":
        return bytes_out * (n - 1) / n
    return bytes_out       # collective-permute


def collective_stats(calls) -> CollectiveStats:
    """``CollectiveStats`` of (op, output bytes, group size, count) rows."""
    counts: Dict[str, float] = {}
    raw: Dict[str, float] = {}
    wire = 0.0
    for op, bytes_out, n, count in calls:
        counts[op] = counts.get(op, 0.0) + count
        raw[op] = raw.get(op, 0.0) + bytes_out * count
        wire += wire_bytes(op, bytes_out, n) * count
    return CollectiveStats(counts, wire, raw)


def cost_terms(global_flops: float, global_bytes: float, chips: int,
               coll: CollectiveStats, peak_flops: float = PEAK_FLOPS,
               hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> Dict[str, float]:
    """Three roofline terms in seconds.

    compute = FLOPs/(chips·peak); memory = bytes/(chips·HBM_bw);
    collective = wire_bytes/link_bw — wire bytes are already per device."""
    return {
        "flops_global": global_flops,
        "bytes_global": global_bytes,
        "collective_bytes_per_device": coll.wire_bytes,
        "t_compute": global_flops / (chips * peak_flops),
        "t_memory": global_bytes / (chips * hbm_bw),
        "t_collective": coll.wire_bytes / link_bw,
    }


def flash_attention_flops(cfg, case, train: bool) -> float:
    """Analytic FLOPs of the flash-attention kernels (invisible to the
    probe: on the meta device they compute nothing).  Per layer forward:
    4·B·H·hd·Σ_q S_eff(q) (QKᵀ + PV, 2 FLOPs per MAC each).  Train factor
    5.5 ≈ fwd + target fwd + remat fwd + bwd (dq/dkv recompute P and run 5
    block dots ≈ 2.5×fwd).  Only reachable blocks execute, so S_eff honors
    causal/window/chunked."""
    if cfg.attn_impl != "flash" or cfg.family in ("ssm",):
        return 0.0
    if case.kind == "decode":
        return 0.0   # decode keeps the cached (naive) path
    s = case.seq_len
    b = case.global_batch
    h, hd = cfg.num_heads, cfg.hd
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.layer_is_global_attn(i) or cfg.attention == "full":
            s_eff_sum = s * (s + 1) / 2                     # causal triangle
        elif cfg.attention == "sliding":
            w = min(cfg.window, s)
            s_eff_sum = w * (w + 1) / 2 + max(s - w, 0) * w
        else:  # chunked-local
            w = min(cfg.window, s)
            s_eff_sum = max(1, s // w) * w * (w + 1) / 2
        total += 4.0 * b * h * hd * s_eff_sum
    # whisper: encoder self-attn + cross-attn keep the naive path (short
    # encoder length, not flash-eligible) — counted by the probe already.
    factor = 5.5 if train else 1.0
    return total * factor


def recurrence_flops_correction(cfg, case, train: bool) -> float:
    """The reference's analytic FLOPs of the mLSTM/sLSTM sequence-scan
    bodies, which XLA's cost analysis counts once instead of ×S.  Per
    token: mLSTM ≈ 12·h·hd² (C/n update + decay + readout), sLSTM ≈ 8·h·hd²
    (4 recurrent head-local matmuls) + O(h·hd); ×5 for training (online
    fwd + remat fwd + bwd 2× + target fwd).  The port's probe counts every
    step's matmuls (``launch/dryrun.py``), so the dry run reports this
    beside its compute term and does not add it."""
    if cfg.family != "ssm":
        return 0.0
    h = cfg.num_heads
    hd = cfg.d_model // h
    toks = case.global_batch * (case.seq_len if case.kind != "decode" else 1)
    per_tok = 0.0
    for i in range(cfg.num_layers):
        per_tok += (8.0 if i in cfg.slstm_at else 12.0) * h * hd * hd
    scale = 5.0 if train else 1.0
    return per_tok * toks * scale


def dominant(terms: Dict[str, float]) -> str:
    keys = ["t_compute", "t_memory", "t_collective"]
    return max(keys, key=lambda k: terms.get(k, 0.0)).replace("t_", "")


# ----------------------------------------------------------- model flops ----

def param_count(cfg) -> Tuple[float, float]:
    """(total, active) parameter counts from the config (analytic)."""
    d, hd = cfg.d_model, cfg.hd
    h, kv, f, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    dense_mlp = 3 * d * f
    total = active = 0.0
    layers = cfg.num_layers
    if cfg.family == "ssm":
        for i in range(layers):
            if i in cfg.slstm_at:
                blk = 4 * d * d + 4 * cfg.num_heads * (d // cfg.num_heads) ** 2 \
                    + d * d + 3 * d * ((d * 4) // 3)
            else:
                blk = 4 * d * d + d * d + 3 * d * (d * 2)
            total += blk
        active = total
    else:
        for i in range(layers):
            lt = attn
            if cfg.family == "hybrid":
                di = cfg.ssm_expand * d
                lt += 2 * d * di + 2 * d * h * cfg.ssm_state + d * h + di * d
            if cfg.layer_is_moe(i):
                e_params = 3 * d * f
                lt_moe = cfg.num_experts * e_params + d * cfg.num_experts
                lt_active = cfg.experts_per_token * e_params
                if cfg.num_shared_experts:
                    shared = 3 * d * f * cfg.num_shared_experts
                    lt_moe += shared
                    lt_active += shared
                total += lt + lt_moe
                active += lt + lt_active
            else:
                total += lt + dense_mlp
                active += lt + dense_mlp
        if cfg.family == "audio":
            enc = cfg.encoder_layers * (attn + dense_mlp)
            cross = cfg.num_layers * attn
            total += enc + cross
            active += enc + cross
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def model_flops(cfg, case) -> float:
    """6·N_active·D train; 2·N_active·tokens for prefill; 2·N_active·B decode."""
    total, active = param_count(cfg)
    toks = case.global_batch * case.seq_len
    if case.kind == "train":
        return 6.0 * active * toks
    if case.kind == "prefill":
        return 2.0 * active * toks
    return 2.0 * active * case.global_batch   # decode: one token per seq
