"""Architecture registry of the port: the configurations it can serve.

``get_config(arch_id)`` returns the exact published configuration;
``get_smoke(arch_id)`` returns a reduced same-family config for CPU tests.
Registered: the dense ``phi4-mini-3.8b`` and the MoE ``olmoe-1b-7b``
(64 experts top-8 on every layer); the other architectures arrive with
their model families.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "get_smoke"]
