"""Architecture configs (``--arch <id>``) — the port's counterpart of
``repro.configs``.

Each module is a copy of the reference's and exposes ``CONFIG`` (the
published configuration) and ``SMOKE`` (a reduced same-family config for
CPU tests).  All ten architectures are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen1_5_32b",
    "granite_8b",
    "internlm2_1_8b",
    "command_r_35b",
    "mixtral_8x7b",
    "llama4_maverick_400b_a17b",
    "hymba_1_5b",
    "whisper_medium",
    "xlstm_125m",
    "phi_3_vision_4_2b",
]


# accepted aliases (the assignment spells them with dashes/dots)
ALIASES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "granite-8b": "granite_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "command-r-35b": "command_r_35b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-medium": "whisper_medium",
    "xlstm-125m": "xlstm_125m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
