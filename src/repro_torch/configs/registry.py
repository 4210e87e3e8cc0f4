"""Architecture registry: ``--arch <id>`` resolution for launchers/tests."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

# arch id -> module name under repro.configs
_ARCH_MODULES: Dict[str, str] = {
    "qwen2.5-32b": "qwen2_5_32b",
    "internlm2-20b": "internlm2_20b",
    "gemma2-27b": "gemma2_27b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-130m": "mamba2_130m",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
