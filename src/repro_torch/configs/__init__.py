"""Architecture registry: the 10 assigned archs + the paper's own workloads.

Copy of ``repro.configs``, which it is held against; the port imports nothing of
``repro``.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "minicpm3-4b": "minicpm3_4b",
    "internlm2-20b": "internlm2_20b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "deepseek-67b": "deepseek_67b",
    "internvl2-26b": "internvl2_26b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-3b": "rwkv6_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def get_reduced_config(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)


__all__ = ["ARCH_IDS", "get_config", "get_reduced_config", "ModelConfig"]
