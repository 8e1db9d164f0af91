"""Training step of the port: CE loss, microbatch gradient accumulation,
global-norm clipping, AdamW (port of ``repro/train/train_loop.py:32-80`` and
``:154-175``, single device), and the adapter-only fine-tuning step of the
reference's Table 4 (``examples/finetune_adapters.py:65-72``).

The state is ``{"model": LM, "opt": adamw state}``; the model holds the fp32
master parameters and the step updates them in place. The activations run
in ``tcfg.compute_dtype`` (the JAX package's ``cast_for_compute``: each
``Linear`` casts its weight to the activation dtype, norm scales stay fp32).
The mesh, the hoisted cast and cross-pod gradient compression wait with
``dist``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         clip_by_global_norm)


def make_train_state(model, generator: Optional[torch.Generator] = None) -> dict:
    """Initialize ``model`` from ``generator`` (on the model's device; None
    keeps the parameters it holds) and attach fresh AdamW state. (The
    reference also takes the TrainConfig, for the cross-pod error-feedback
    state, which the single-device port does not keep.)"""
    if generator is not None:
        model.init(generator)
    return {"model": model, "opt": adamw_init(dict(model.named_parameters()))}


def make_train_step(model, tcfg: TrainConfig, ctx: ParallelCtx = CPU_CTX):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with batch
    ``{"tokens": (B, T) ints}`` (a vlm's also ``vision_embeds``, split into
    the microbatches with the tokens). ``ctx`` must not select the flash kernel,
    which has no backward (its wrapper raises under autograd)."""
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    mb = tcfg.microbatches

    def train_step(state, batch):
        model_ = state["model"]
        params = dict(model_.named_parameters())
        tokens = batch["tokens"]
        b = tokens.shape[0]
        if b % mb:
            raise ValueError(f"batch of {b} rows does not split into {mb} "
                             "microbatches")
        for p in params.values():
            p.grad = None
        ce = torch.zeros((), dtype=torch.float32, device=tokens.device)
        aux = torch.zeros_like(ce)
        vis = batch.get("vision_embeds")
        parts = zip(tokens.chunk(mb, dim=0),
                    vis.chunk(mb, dim=0) if vis is not None else [None] * mb)
        for part, vpart in parts:
            loss, metrics = model_.loss(part, vision_embeds=vpart, ctx=ctx,
                                        compute_dtype=compute_dtype)
            (loss / mb).backward()
            ce = ce + metrics["ce"].detach() / mb
            aux = aux + metrics["aux"].detach() / mb
        grads = {k: p.grad for k, p in params.items()}
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        _, opt, lr = adamw_update(tcfg, params, grads, state["opt"])
        for p in params.values():
            p.grad = None
        new_state = {"model": model_, "opt": opt}
        return new_state, {"ce": ce, "aux": aux, "loss": ce + aux,
                           "grad_norm": gnorm, "lr": lr}

    return train_step


def make_adapter_step(model, tcfg: TrainConfig, mask, ctx: ParallelCtx = CPU_CTX):
    """Returns ``adapter_step(opt, tokens) -> (loss, grads of the trainable
    leaves)``: the reference's adapter-only fine-tuning step — the fp32 loss,
    every leaf's gradient with the frozen ones zeroed (the reference's
    ``mask_grads``), then AdamW over every leaf, no clipping. So a frozen
    ``w`` still decays by lr · wd · w when ``weight_decay > 0``, as in the
    reference.

    The frozen leaves are marked ``requires_grad=False`` on ``model``, so
    autograd forms none of their gradients (no dense ``w`` gradient
    products); AdamW is handed zeros for them. On the card the adapters' products run through the ``lowrank_linear``
    kernel, forward and backward. ``opt`` is ``adamw_init`` of the model's
    parameters, updated in place."""
    params = dict(model.named_parameters())
    for k, p in params.items():
        p.requires_grad_(bool(mask[k]))

    def adapter_step(opt, tokens):
        for p in params.values():
            p.grad = None
        loss, _ = model.loss(tokens, ctx=ctx, compute_dtype=torch.float32)
        loss.backward()
        grads = {k: p.grad if mask[k] else torch.zeros_like(p)
                 for k, p in params.items()}
        adamw_update(tcfg, params, grads, opt)
        trained = {k: g for k, g in grads.items() if mask[k]}
        for p in params.values():
            p.grad = None
        return loss.detach(), trained

    return adapter_step
