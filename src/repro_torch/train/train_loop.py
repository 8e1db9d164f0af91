"""Training step of the port: CE loss, microbatch gradient accumulation,
global-norm clipping, AdamW, mixed precision and layer rematerialization
(port of ``repro/train/train_loop.py:22-80`` and ``:154-175``), on one
device or on a mesh of ranks over the ``pod`` and ``data`` axes (a model
axis of 1), and the adapter-only fine-tuning step of the reference's Table 4
(``examples/finetune_adapters.py:65-72``).

The state is ``{"model": LM, "opt": adamw state[, "err"]}``; the model holds
the fp32 master parameters and the step updates them in place. The forward
runs on ``cast_for_compute``'s copy of them, so under a bf16
``compute_dtype`` every leaf the reference rounds (its ndim >= 2, stacking
included) is rounded before any module reads it, and autograd carries the
gradients back to the fp32 master through the cast, as the reference's
gradient passes through ``astype``.

On a mesh every rank holds the whole state (the parameters and moments
replicated, the residuals ``err`` the rank's pod row) and runs its rows of
the global batch; the reduced gradients are the same bits on every rank, so
clipping and AdamW keep every rank's parameters the same bits. The
reference's three branches: ``grad_compress_pods`` (int8 error feedback
across pods, ``train/grad_compress.py``), the plain fp32 mean over every
rank (the counterpart of the reduction of the reference's FSDP step), and one
device. A model axis above 1 (tensor parallelism, FSDP's sharded storage),
an MoE layer on a mesh and the hoisted cast wait with ROADMAP Queue 1, item
13b-2: they need device collectives at every layer, which one card cannot
give several ranks.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.config import TrainConfig
from repro_torch.convert import reference_leaves
from repro_torch.dist.sharding import batch_shard
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.train import grad_compress as gc
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         clip_by_global_norm, reference_ndim)


def cast_for_compute(model, dtype) -> Dict[str, torch.Tensor]:
    """The reference's ``cast_for_compute`` (``repro/train/train_loop.py:
    22-29``) on the port's parameters: ``{name: tensor}`` with every floating
    parameter whose ndim in the reference's tree (``reference_ndim``: the
    ``blocks``/``enc``/``dec`` leaves are stacked, so their norm scales,
    routers and Mamba vectors count as matrices) is >= 2 cast to ``dtype``,
    differentiably; the rest (the final norms, a prefix layer's norm scales)
    are the parameters themselves."""
    return {name: (p.to(dtype) if p.is_floating_point()
                   and reference_ndim(name, p) >= 2 else p)
            for name, p in model.named_parameters()}


@contextlib.contextmanager
def compute_parameters(model, dtype):
    """Within the block ``model``'s modules read ``cast_for_compute(model,
    dtype)`` in place of the parameters it casts (as ``torch.func.
    functional_call`` swaps them, but for the forward and the backward
    alike: a rematerialized layer recomputes its forward in the backward
    and must read the same copies). The gradients reach the fp32 master
    through the casts."""
    swapped = []
    try:
        for name, t in cast_for_compute(model, dtype).items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            if mod._parameters[leaf] is not t:
                swapped.append((mod, leaf, mod._parameters[leaf]))
                mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(swapped):
            mod._parameters[leaf] = p


MESH_REFUSED = "ROADMAP Queue 1, item 13b-2"


def check_mesh(sizes: Dict[str, int], cfg) -> None:
    """Raise for what a mesh of axis ``sizes`` does not take in this slice:
    a model axis above 1, an MoE layer on a mesh of several ranks."""
    if sizes.get("model", 1) > 1:
        raise ValueError(f"a model axis of {sizes['model']} (tensor parallelism, FSDP's "
                         f"sharded storage) is {MESH_REFUSED}")
    if cfg.uses_moe and math.prod(sizes.values()) > 1:
        raise ValueError(f"an MoE layer on a mesh (the expert-parallel MoE, and the "
                         f"MoE over each pod's batch under grad compression) is "
                         f"{MESH_REFUSED}")


def make_train_state(model, generator: Optional[torch.Generator] = None,
                     tcfg: Optional[TrainConfig] = None) -> dict:
    """Initialize ``model`` from ``generator`` (on the model's device; None
    keeps the parameters it holds) and attach fresh AdamW state. With
    ``tcfg.grad_compress_pods`` the state keeps ``err``, None until the
    launcher knows the pod count (``gc.init_error_state``), as the
    reference's does."""
    if generator is not None:
        model.init(generator)
    state = {"model": model, "opt": adamw_init(dict(model.named_parameters()))}
    if tcfg is not None and tcfg.grad_compress_pods:
        state["err"] = None
    return state


def make_train_step(model, tcfg: TrainConfig, ctx: ParallelCtx = CPU_CTX,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with batch
    ``{"tokens": (B, T) ints}`` and the model's other inputs (a vlm's
    ``vision_embeds``, an encoder–decoder's ``frames``). Each loss and
    backward runs on ``cast_for_compute(model, tcfg.compute_dtype)``
    (``compute_parameters``) with ``tcfg.remat``. ``ctx`` must not select
    the flash kernel, which has no backward (its wrapper raises under
    autograd).

    ``mesh`` (a ``DeviceMesh`` with ``pod``, ``data`` and ``model`` axes,
    ``launch/mesh.py``) makes it this rank's step: the batch is the global
    one and the rank takes its rows (``batch_shard``). With
    ``grad_compress_pods`` the gradients go through
    ``gc.make_compressed_grads_fn`` (one pass over the rank's rows, as the
    reference's compressed branch takes no microbatches; ``state["err"]``
    the pod's row, the error feedback's local identities in the metrics as
    ``ef_own``, ``ef_sum`` and ``ef_scale``); without, they are averaged in
    fp32 over every rank. Either way the metrics are the mean over the ranks
    and carry ``bytes_sent`` and ``reduce_seconds``. Without a
    mesh the step splits the batch into ``tcfg.microbatches`` and takes the
    cast per microbatch, as the reference's ``mb_loss``."""
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    if mesh is not None:
        check_mesh(dict(zip(mesh.mesh_dim_names, mesh.shape)), model.cfg)
    use_compress = bool(tcfg.grad_compress_pods) and mesh is not None \
        and "pod" in mesh.mesh_dim_names

    def loss_and_grad(model_, batch, mb):
        """(ce, aux, {name: gradient}) of the mean loss over ``batch``,
        accumulated over ``mb`` microbatches."""
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
        extras = {k: v.chunk(mb, dim=0) for k, v in batch.items()
                  if k != "tokens"}
        for i, part in enumerate(tokens.chunk(mb, dim=0)):
            with compute_parameters(model_, compute_dtype):
                loss, metrics = model_.loss(
                    part, ctx=ctx, compute_dtype=compute_dtype,
                    remat=tcfg.remat, **{k: v[i] for k, v in extras.items()})
                (loss / mb).backward()
            ce = ce + metrics["ce"].detach() / mb
            aux = aux + metrics["aux"].detach() / mb
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return ce, aux, grads

    if use_compress:
        def pod_loss_and_grad(params, batch):
            ce, aux, grads = loss_and_grad(model, batch, 1)
            return (ce + aux, {"ce": ce, "aux": aux}), grads

        compressed = gc.make_compressed_grads_fn(
            pod_loss_and_grad, mesh, leaves=reference_leaves(model))

    def mesh_mean(model_, batch):
        """The plain branch on a mesh: the fp32 mean over every rank."""
        ce, aux, grads = loss_and_grad(model_, batch_shard(batch, mesh),
                                       tcfg.microbatches)
        t0 = gc.synced_clock(ce.device)
        flat, sent = gc.mean_over(gc.pack(grads), dist.group.WORLD)
        scalars, sent_m = gc.mean_over(torch.stack([ce, aux]), dist.group.WORLD)
        return (scalars[0], scalars[1], gc.unpack(flat, grads),
                {"bytes_sent": sent + sent_m,
                 "reduce_seconds": gc.synced_clock(ce.device) - t0})

    def train_step(state, batch):
        model_ = state["model"]
        params = dict(model_.named_parameters())
        new_err, stats = state.get("err"), {}
        if use_compress:
            _, metrics, grads, new_err, stats = compressed(params, batch, state["err"])
            ce, aux = metrics["ce"], metrics["aux"]
        elif mesh is not None:
            ce, aux, grads, stats = mesh_mean(model_, batch)
        else:
            ce, aux, grads = loss_and_grad(model_, batch, tcfg.microbatches)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        _, opt, lr = adamw_update(tcfg, params, grads, state["opt"])
        new_state = {"model": model_, "opt": opt}
        if "err" in state:
            new_state["err"] = new_err
        return new_state, {"ce": ce, "aux": aux, "loss": ce + aux,
                           "grad_norm": gnorm, "lr": lr, **stats}

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
