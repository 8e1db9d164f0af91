"""Architecture registry of the port: ``get_config(name)`` / ``get_smoke_config``.

Only llama3_1b is ported so far; the other configs of ``repro.configs``
come with their model families.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = ["llama3_1b"]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    key = _norm(name)
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
