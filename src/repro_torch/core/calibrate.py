"""Calibration: stream per-layer activations into R factors (port of
``repro/core/calibrate.py:26-95``).

Each target linear owns an ``RStreamer``; every captured activation chunk
folds into a running n×n R via TSQR, so the calibration matrix X is never
materialized. Capture is a forward pre-hook on every ``Linear`` of the
decoder blocks, keyed by the JAX parameter path ('blocks/3/sub0/mixer/wq').
The Gram accumulator (``collect_gram``) waits with the ``gram_accum`` kernel.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch

from repro_torch.core.tsqr import RStreamer, square_r
from repro_torch.models.linear import Linear


def linear_paths(model):
    """(JAX-style path, Linear) for every projection in the decoder blocks."""
    for name, mod in model.blocks.named_modules(prefix="blocks"):
        if isinstance(mod, Linear):
            yield name.replace(".", "/"), mod


MAX_TOKENS_PER_RECORD = 8192     # rows folded per QR (bounds the QR stack)


class Calibrator:
    """Capture sink + R accumulator (fp32). Use via ``model.capture_forward``."""

    def __init__(self):
        self.streams: Dict[str, RStreamer] = {}

    @contextlib.contextmanager
    def capture(self, model):
        """Record the inputs of every dense block linear while active."""
        handles = []
        for path, mod in linear_paths(model):
            if mod.is_factored:
                continue
            handles.append(mod.register_forward_pre_hook(
                lambda _mod, args, path=path: self.record(path, args[0])))
        try:
            yield self
        finally:
            for h in handles:
                h.remove()

    def record(self, path: str, x: torch.Tensor) -> None:
        n = x.shape[-1]
        flat = x.float().reshape(-1, n)
        if path not in self.streams:
            self.streams[path] = RStreamer(n)
        for i in range(0, flat.shape[0], MAX_TOKENS_PER_RECORD):
            self.streams[path].update(flat[i:i + MAX_TOKENS_PER_RECORD])

    def r_factors(self) -> Dict[str, torch.Tensor]:
        return {p: square_r(s.r) for p, s in self.streams.items()}

    def tokens_seen(self) -> Dict[str, int]:
        return {p: s.tokens_seen for p, s in self.streams.items()}


def calibrate_model(model, batches: Iterable[torch.Tensor]) -> Calibrator:
    """Run capture over calibration token batches (each (B, T) ints on the
    model's device); returns the filled Calibrator."""
    cal = Calibrator()
    for tokens in batches:
        model.capture_forward(tokens, cal)
    return cal
