"""Model substrate of the port: build an LM from its ModelConfig."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, *, device="cuda", dtype=torch.float32) -> LM:
    """An ``LM`` on ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"``). Parameters are zero until ``init`` or
    ``convert.params_from_numpy`` fills them."""
    return LM(cfg, device=device, dtype=dtype)


__all__ = ["LM", "build_model"]
