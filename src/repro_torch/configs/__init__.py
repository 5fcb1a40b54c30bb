"""Architecture registry of the port: the configurations it can serve.

``get_config(arch_id)`` returns the exact published configuration;
``get_smoke(arch_id)`` returns a reduced same-family config for CPU tests.
The ten architectures of the JAX package's registry, in its order: the
SSM ``rwkv6-7b`` (RWKV-6), the encoder-decoder ``seamless-m4t-medium``
(a stub frontend's frame embeddings into the encoder), the dense
decoders ``qwen2-vl-72b`` (M-RoPE), ``mistral-nemo-12b``,
``command-r-plus-104b`` (qk-norm, tied embeddings), ``h2o-danube-1.8b``
(sliding window) and ``phi4-mini-3.8b``, the MoE ``olmoe-1b-7b`` (64
experts top-8 on every layer) and ``llama4-maverick-400b-a17b`` (128
experts top-1 and a shared expert on every second layer), and the
hybrid ``zamba2-1.2b`` (Mamba2 with a shared attention block).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "rwkv6-7b": "rwkv6_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "command-r-plus-104b": "command_r_plus_104b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "zamba2-1.2b": "zamba2_1_2b",
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
