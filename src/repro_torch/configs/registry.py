"""Architecture registry: ``--arch <id>`` lookup for full and smoke
configs."""
from __future__ import annotations

from repro_torch.configs import (stablelm_3b, minitron_8b, gemma3_1b,
                                 granite_20b, qwen3_moe_235b, moonshot_16b,
                                 internvl2_1b, whisper_base, zamba2_1p2b,
                                 rwkv6_1p6b)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "stablelm-3b": stablelm_3b,
    "minitron-8b": minitron_8b,
    "gemma3-1b": gemma3_1b,
    "granite-20b": granite_20b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "moonshot-v1-16b-a3b": moonshot_16b,
    "internvl2-1b": internvl2_1b,
    "whisper-base": whisper_base,
    "zamba2-1.2b": zamba2_1p2b,
    "rwkv6-1.6b": rwkv6_1p6b,
}

ARCH_IDS = tuple(_MODULES)
CONFIGS = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_CONFIGS = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return CONFIGS[name]


def get_smoke_config(name: str) -> ModelConfig:
    if name not in SMOKE_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return SMOKE_CONFIGS[name]
