"""Architecture registry of the port: the dense and SSM architectures it
serves. ``get_config(id)`` / ``get_smoke(id)`` as in the JAX package; the
JAX package's other architectures raise ``NotImplementedError`` until
their family is ported.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# arch id -> module name (the dense and SSM families)
ARCH_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "olmo-1b": "olmo_1b",
    "mamba2-370m": "mamba2_370m",
    "deepseek-67b": "deepseek_67b",
    "command-r-35b": "command_r_35b",
}

# The JAX package's architectures of families the port does not run yet.
NOT_PORTED = ("zamba2-2.7b", "dbrx-132b",
              "phi-3-vision-4.2b", "whisper-medium",
              "llama4-maverick-400b-a17b")

ARCH_IDS: List[str] = list(ARCH_MODULES)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: its family is not ported yet; the port serves "
            f"{ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE

