"""Architecture registry: one module per architecture the port runs.

Counterpart of `repro/configs/__init__.py`.  The port registers the archs
of the families its `models/transformer.py` runs, in the JAX package's
order: the moe archs `phi35_moe` and `mixtral_8x22b`, the dense archs
`minitron_4b`, `qwen2_7b`, `olmo_1b` and `granite_8b`, the hybrid arch
`recurrentgemma_2b`, the vlm arch `internvl2_76b`, the ssm arch
`mamba2_1_3b` and the audio arch `whisper_medium` (each module's
`CONFIG` and `smoke_config()` equal the JAX package's field for field).
`get_config` of a name outside the registry raises ValueError.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "get_smoke_config", "shape_applicable"]

ARCH_IDS = [
    "phi35_moe",
    "mixtral_8x22b",
    "minitron_4b",
    "qwen2_7b",
    "olmo_1b",
    "granite_8b",
    "recurrentgemma_2b",
    "internvl2_76b",
    "mamba2_1_3b",
    "whisper_medium",
]

_ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "mixtral-8x22b": "mixtral_8x22b",
    "minitron-4b": "minitron_4b",
    "qwen2-7b": "qwen2_7b",
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-1.3b": "mamba2_1_3b",
    "whisper-medium": "whisper_medium",
}


def _module(arch: str):
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the registry holds "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()

