"""Deterministic synthetic token pipeline (port of
``repro/data/pipeline.py:25-87``).

Every batch is a pure function of (seed, step): restarting at step N gives
the same stream with nothing to persist but the step. With probability
1 - noise the next token is the affine map ``(x·3 + 7 + offset) % vocab`` of
the current one (offset fixed per row), else uniform noise, so a small model
learns well below the uniform CE. The bits come from a CPU
``torch.Generator`` seeded with a mix of (seed, step); they cannot equal
jax.random's, so the tokens differ from the JAX package's while the
recurrence and the determinism are the same. A vlm's batch also carries
``vision_embeds`` (B, n_vision_tokens, d_model) N(0, 1) from a generator
seeded with ``fold_in(seed + 2, step)``, the reference's key
(``repro/data/pipeline.py:70-74``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch import resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    noise: float = 0.15


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, step: int) -> int:
    """A generator seed for (seed, step): two splitmix64 rounds."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (step & _MASK64)) >> 1


def _batch_tokens(dcfg: DataConfig, step: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(fold_in(dcfg.seed, step))
    b, t, v = dcfg.global_batch, dcfg.seq_len, dcfg.vocab_size
    x = torch.randint(0, v, (b,), generator=gen)
    offset = torch.randint(0, 7, (b,), generator=gen)
    noise = torch.randint(0, v, (t - 1, b), generator=gen)
    use_noise = torch.rand((t - 1, b), generator=gen) < dcfg.noise
    rows = [x]
    for i in range(t - 1):
        x = torch.where(use_noise[i], noise[i], (x * 3 + 7 + offset) % v)
        rows.append(x)
    return torch.stack(rows, dim=1).to(torch.int32)


def _vision_embeds(dcfg: DataConfig, cfg, step: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(fold_in(dcfg.seed + 2, step))
    return torch.randn((dcfg.global_batch, cfg.n_vision_tokens, cfg.d_model),
                       generator=gen)


class TokenPipeline:
    """get_batch(step) -> {"tokens": (B, T) int32 on ``device``}, plus
    ``vision_embeds`` (B, n_vision_tokens, d_model) fp32 for a vlm."""

    def __init__(self, dcfg: DataConfig, model_cfg=None, *, device="cuda"):
        if model_cfg is not None and model_cfg.family not in ("dense", "moe",
                                                              "vlm"):
            raise NotImplementedError(
                f"family {model_cfg.family!r} has no ported batch extras")
        self.dcfg = dcfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = {"tokens": _batch_tokens(self.dcfg, step).to(self.device)}
        cfg = self.model_cfg
        if cfg is not None and cfg.family == "vlm":
            batch["vision_embeds"] = _vision_embeds(self.dcfg, cfg,
                                                    step).to(self.device)
        return batch

    def iter_from(self, step: int) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.get_batch(step)
            step += 1


def calibration_stream(dcfg: DataConfig, n_batches: int, *, device="cuda"):
    """Deterministic calibration batches (for activation capture)."""
    pipe = TokenPipeline(dcfg, device=device)
    for i in range(n_batches):
        yield pipe.get_batch(10_000_000 + i)     # disjoint from train stream
