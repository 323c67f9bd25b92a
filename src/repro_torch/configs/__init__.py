"""Architecture registry: one module per architecture the port runs.

Counterpart of `repro/configs/__init__.py`; only the archs whose family
the port's `models/transformer.py` runs are registered (the dense
`olmo_1b`).  `get_config` of another arch raises ValueError.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "get_smoke_config"]

ARCH_IDS = [
    "olmo_1b",
]

_ALIASES = {
    "olmo-1b": "olmo_1b",
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

