"""Model substrate of the port: build a model from its ModelConfig."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM

# the layer lists the JAX tree stacks over a leading layer axis
STACKED = ("blocks", "enc", "dec")


def build_model(cfg: ModelConfig, *, device="cuda", dtype=torch.float32
                ) -> Union[LM, EncDecLM]:
    """An ``EncDecLM`` for family ``encdec``, else an ``LM``, on ``device``
    (default ``"cuda"``; raises without a GPU unless ``device="cpu"``).
    Parameters are zero until ``init`` or ``convert.params_from_numpy``
    fills them."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device, dtype=dtype)
    return LM(cfg, device=device, dtype=dtype)


__all__ = ["EncDecLM", "LM", "STACKED", "build_model"]
