"""Int8 gradient compression with error feedback (port of
``repro/train/grad_compress.py:43-84`` and ``:140``).

Across pods the reference reduces int8-quantized gradients with error
feedback:

    q_t  = quant(g_t + e_{t-1})
    ĝ_t  = mean_pods(dequant(q_t))
    e_t  = (g_t + e_{t-1}) - dequant(q_t)       # residual kept on the pod

Quantization is per-block(128) symmetric int8 with a scale per block in the
input's dtype (fp32 for fp32 gradients), the tail padded with zeros to a
whole block. This module holds the quantizer, its inverse, the error state
and the single-device round trip, in plain torch as the reference holds them
in plain jnp (it has no kernel here). The reduction over a pod axis
(``quantized_mean_leaf``, ``error_state_specs``,
``make_compressed_grads_fn``) waits with the distributed slice: on one
device there is no pod to reduce over, and the reference's launcher adds no
error state there either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

BLOCK = 128


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (int8 payload (n_blocks, BLOCK),
    scales (n_blocks, 1) in ``x``'s dtype)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """fp32 values of ``q`` · ``scale``, cut to ``shape``."""
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def init_error_state(params: Dict[str, torch.Tensor], n_pods: int
                     ) -> Dict[str, torch.Tensor]:
    """fp32 residuals with an explicit leading pod axis, one per parameter."""
    return {k: torch.zeros((n_pods,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device)
            for k, p in params.items()}


def simulate_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Single-device quantize → dequantize, in ``g``'s dtype."""
    q, s = _quantize(g)
    return _dequantize(q, s, g.shape).to(g.dtype)
