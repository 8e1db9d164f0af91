"""Gated MLP (port of ``repro/models/ffn.py:30-50``; MoE waits)."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn
from repro_torch.models.linear import Linear


class MLP(torch.nn.Module):
    """down(act(gate(x)) * up(x))."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)
        self.gate = Linear(d_model, d_ff, **kw)
        self.act = act_fn(act)

    def forward(self, x):
        return self.down(self.act(self.gate(x)) * self.up(x))
