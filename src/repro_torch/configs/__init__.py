"""Architecture registry of the port: ``get_config(name)`` / ``get_smoke_config``.

Each module is a copy of its ``repro.configs`` counterpart: CONFIG (the full
configuration) and SMOKE (a reduced same-family configuration for CPU
tests). Ported: the dense GQA families, deepseek's MoE, deepseek-v2's MLA
attention over MoE, qwen2-vl's vision prefix with M-RoPE, xLSTM's recurrent
mLSTM/sLSTM blocks, whisper's encoder-decoder and jamba's hybrid of Mamba and
attention layers over MoE: every configuration of the reference. A name in
``NOT_PORTED`` (none now) would raise ``NotImplementedError`` naming its
family.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "deepseek_moe_16b",
    "deepseek_v2_lite_16b",
    "gemma2_27b",
    "olmo_1b",
    "smollm_135m",
    "minicpm_2b",
    "qwen2_vl_2b",
    "xlstm_1_3b",
    "whisper_base",
    "jamba_v0_1_52b",
    # the paper's own evaluation models (compression targets)
    "llama3_1b",
    "mistral_7b",
]

# the reference's other configuration, by the family that keeps it out
NOT_PORTED: Dict[str, str] = {}


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    key = _norm(name)
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet: family {NOT_PORTED[key]} "
            f"(ported: {ARCH_IDS})")
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"config {name!r} is unknown (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
