"""Architecture registry of the port: the JAX package's ten architectures.
``get_config(id)`` / ``get_smoke(id)`` / ``all_configs()`` as in the JAX
package, each config a copy of the JAX file's ``FULL`` and ``SMOKE``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

# arch id -> module name, in the JAX package's order
ARCH_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "deepseek-7b": "deepseek_7b",
    "zamba2-2.7b": "zamba2_2p7b",
    "olmo-1b": "olmo_1b",
    "dbrx-132b": "dbrx_132b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "deepseek-67b": "deepseek_67b",
    "whisper-medium": "whisper_medium",
    "command-r-35b": "command_r_35b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
}

ARCH_IDS: List[str] = list(ARCH_MODULES)


def _module(arch_id: str):
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
