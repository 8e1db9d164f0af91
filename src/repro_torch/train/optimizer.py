"""AdamW (fp32 master) + LR schedules (cosine, WSD, const) — port of
``repro/train/optimizer.py:17-93``.

Parameters and optimizer state are dicts of tensors keyed by the model's
parameter names. Where the JAX functions return new trees, ``adamw_update``
and ``clip_by_global_norm`` update the tensors in place: at full llama3_1b
width a second copy of the parameters or gradients would cost ~5 GB each.

WSD (warmup–stable–decay) is MiniCPM's schedule [arXiv:2404.06395]: linear
warmup, long stable plateau, short (decay_frac) 1-sqrt-style decay tail.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.config import TrainConfig
from repro_torch.models import STACKED


def lr_at(tcfg: TrainConfig, step) -> float:
    """Learning rate at ``step`` (0-based), computed in fp32 as the
    reference does."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731
    step_t = f32(float(step))
    warm, total, base = (f32(float(tcfg.warmup_steps)),
                         f32(float(tcfg.total_steps)), f32(tcfg.lr))
    warm_lr = base * torch.clamp((step_t + 1) / torch.clamp(warm, min=1.0),
                                 max=1.0)
    if tcfg.schedule == "const":
        return float(warm_lr)
    if tcfg.schedule == "cosine":
        t = torch.clamp((step_t - warm) / torch.clamp(total - warm, min=1.0),
                        0.0, 1.0)
        cos = base * 0.5 * (1.0 + torch.cos(math.pi * t))
        return float(warm_lr if step_t < warm else cos)
    if tcfg.schedule == "wsd":
        decay_steps = torch.clamp(total * tcfg.decay_frac, min=1.0)
        decay_start = total - decay_steps
        t = torch.clamp((step_t - decay_start) / decay_steps, 0.0, 1.0)
        decayed = base * (1.0 - torch.sqrt(t)) + base * 0.1 * torch.sqrt(t)
        if step_t < warm:
            return float(warm_lr)
        return float(base if step_t < decay_start else decayed)
    raise ValueError(f"unknown schedule {tcfg.schedule}")


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """ndim of parameter ``name`` in the JAX tree, which stacks every block
    leaf over ``n_rep`` and an encoder–decoder's layers over their layer
    axis: the port's ndim + 1 under ``blocks.``, ``enc.`` and ``dec.``."""
    return p.ndim + 1 if name.split(".", 1)[0] in STACKED else p.ndim


def adamw_init(params: Dict[str, torch.Tensor]) -> dict:
    """fp32 first and second moments per parameter, and the step count."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return {"m": zeros(), "v": zeros(), "step": 0}


@torch.no_grad()
def adamw_update(tcfg: TrainConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: dict):
    """One AdamW step at lr_at(step - 1), decoupled weight decay on tensors
    with ndim >= 2 in the reference's tree (``reference_ndim``: so also the
    block norm scales, which the reference stacks to (n_rep, d), Mamba's
    ``dt_bias`` and ``d_skip``, stacked to (n_rep, d_inner), and an
    encoder–decoder's layer norm scales, stacked to (n_layers, d)), all fp32
    math. ``params`` are keyed by the model's parameter names. Updates
    ``params`` and the moments in place; returns (params, opt_state, lr)."""
    step = opt_state["step"] + 1
    lr = lr_at(tcfg, step - 1)
    b1, b2, eps = tcfg.b1, tcfg.b2, tcfg.eps
    bc1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** step)
    for k, p in params.items():
        g = grads[k].float()
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if reference_ndim(k, p) >= 2:
            delta.add_(p.float(), alpha=tcfg.weight_decay)
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (fp32)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, norm before clipping)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm
