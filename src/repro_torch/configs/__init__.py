"""Architecture registry: one module per architecture the port runs.

Counterpart of `repro/configs/__init__.py`.  The port registers the four
dense archs, the family its `models/transformer.py` runs: `olmo_1b`,
`granite_8b`, `minitron_4b` and `qwen2_7b` (each module's `CONFIG` and
`smoke_config()` equal the JAX package's field for field).  An arch of
another family (moe, hybrid, ssm, vlm, audio) is not registered, and
`get_config` of it raises ValueError.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "get_smoke_config"]

ARCH_IDS = [
    "minitron_4b",
    "qwen2_7b",
    "olmo_1b",
    "granite_8b",
]

_ALIASES = {
    "minitron-4b": "minitron_4b",
    "qwen2-7b": "qwen2_7b",
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
}


def _module(arch: str):
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported; the port runs "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()

