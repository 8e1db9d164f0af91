"""Calibration: stream per-layer activations into R factors (port of
``repro/core/calibrate.py:26-95``).

Each target linear owns an ``RStreamer``; every captured activation chunk
folds into a running n×n R via TSQR, so the calibration matrix X is never
materialized. Capture is a forward pre-hook on every ``Linear`` of the
layer stacks, keyed by the JAX parameter path ('blocks/3/sub0/mixer/wq',
'prefix/0/ffn/up', an encoder–decoder's 'enc/0/attn/wq' and
'dec/1/cross/wk'), and each MoE layer's ``expert_sink``, which records per
expert the inputs of the tokens it took with a non-zero gate and their GLU
hidden states ('blocks/0/sub0/ffn/expert5/in', '…/expert5/hid'), as the
reference's ``CaptureDict`` does.
With ``collect_gram`` each record also adds its Gram contribution aᵀa
(``ops.gram_accum``, the CUDA kernel on the card) for the SVD-LLM family.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch

from repro_torch.core.tsqr import RStreamer, square_r
from repro_torch.kernels import ops
from repro_torch.models import STACKED
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.models.ffn import MoE
from repro_torch.models.linear import Linear
from repro_torch.obs import trace


def block_modules(model, kind):
    """(JAX-style path, module) of every module of type ``kind`` in the
    layer stacks, in depth order: an LM's prefix layers, then its blocks;
    an encoder–decoder's encoder layers, then its decoder layers."""
    for head in ("prefix",) + STACKED:
        if not hasattr(model, head):
            continue
        for name, mod in getattr(model, head).named_modules(prefix=head):
            if isinstance(mod, kind):
                yield name.replace(".", "/"), mod


def linear_paths(model):
    """(JAX-style path, Linear) for every projection in the layer stacks,
    in ``block_modules``' order."""
    yield from block_modules(model, Linear)


def moe_paths(model):
    """(JAX-style path, MoE) for every MoE FFN ('blocks/0/sub0/ffn')."""
    yield from block_modules(model, MoE)


MAX_TOKENS_PER_RECORD = 8192     # rows folded per QR (bounds the QR stack)


class Calibrator:
    """Capture sink + R accumulator (fp32), and with ``collect_gram`` a Gram
    accumulator XXᵀ per path. Use via ``model.capture_forward``."""

    def __init__(self, *, collect_gram: bool = False):
        self.streams: Dict[str, RStreamer] = {}
        self.grams: Dict[str, torch.Tensor] = {}
        self.collect_gram = collect_gram

    @contextlib.contextmanager
    def capture(self, model):
        """Record the inputs of every dense block linear, and every MoE
        layer's per-expert inputs and hidden states, while active."""
        handles = []
        for path, mod in linear_paths(model):
            if not mod.has_dense:      # the reference captures {"w", ...}
                continue
            handles.append(mod.register_forward_pre_hook(
                lambda _mod, args, path=path: self.record(path, args[0])))
        moes = list(moe_paths(model))
        for path, moe in moes:
            moe.expert_sink = (lambda name, x, path=path:
                               self.record(f"{path}/{name}", x))
        try:
            yield self
        finally:
            for h in handles:
                h.remove()
            for _, moe in moes:
                moe.expert_sink = None

    def record(self, path: str, x: torch.Tensor) -> None:
        """Fold one captured input ``x`` (..., n) of the linear at ``path``
        into its R (and Gram). Every capture hook calls this method, so a
        subclass can narrow what is folded (``serve/recalibrate.py``'s
        ``TrafficCalibrator`` slices the positions it has not seen)."""
        n = x.shape[-1]
        flat = x.float().reshape(-1, n)
        with trace.span("calib.record", path=path, tokens=flat.shape[0]):
            if path not in self.streams:
                self.streams[path] = RStreamer(n)
            for i in range(0, flat.shape[0], MAX_TOKENS_PER_RECORD):
                self.streams[path].update(flat[i:i + MAX_TOKENS_PER_RECORD])
            if self.collect_gram:
                g = ops.gram_accum(flat.contiguous())
                self.grams[path] = (g if path not in self.grams
                                    else self.grams[path] + g)

    def reset(self) -> None:
        """Drop every accumulated stream and Gram, keeping the instance."""
        self.streams.clear()
        self.grams.clear()

    def r_factors(self) -> Dict[str, torch.Tensor]:
        return {p: square_r(s.r) for p, s in self.streams.items()}

    def thin_r_factors(self) -> Dict[str, torch.Tensor]:
        """Every stream's R as accumulated, (k <= n, n): ``square_r`` of it
        is ``r_factors()``'s, without holding every square R at once."""
        return {p: s.r for p, s in self.streams.items()}

    def tokens_seen(self) -> Dict[str, int]:
        return {p: s.tokens_seen for p, s in self.streams.items()}


def calibrate_model(model, batches: Iterable, *, collect_gram: bool = False,
                    ctx: ParallelCtx = CPU_CTX) -> Calibrator:
    """Run capture over calibration batches on the model's device — each
    (B, T) token ints, or a pipeline batch ``{"tokens", ...}`` whose other
    entries are the model's inputs beside the tokens (a vlm's
    ``vision_embeds`` prefix, an encoder–decoder's ``frames``), which go
    through the forward too; returns the filled Calibrator. ``ctx`` picks the
    attention path of the forward (the flash kernel with ``use_pallas``); it
    changes no result beyond rounding."""
    cal = Calibrator(collect_gram=collect_gram)
    for batch in batches:
        if isinstance(batch, dict):
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            model.capture_forward(batch["tokens"], cal, ctx=ctx, **extras)
        else:
            model.capture_forward(batch, cal, ctx=ctx)
    return cal
