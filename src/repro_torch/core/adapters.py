"""PEFT adapter initialization (paper §6.2, Table 4; port of
``repro/core/adapters.py``).

Unified through Proposition 4's (XXᵀ)^α family:

  * lora   — random Bᵀ (``b_t``), zero Aᵀ (``a_t``) (Hu et al.)
  * pissa  — α=0: principal subspace of W itself (Meng et al.)
  * corda  — α=2 via the fragile Gram-inverse form (Remark 1 baseline)
  * coala  — α∈{1,2} inversion-free (the paper's robustified variants;
             ``coala_a<α>``, plain ``coala`` is α=1)

Each method turns a target ``Linear`` into the three-leaf form: the dense
residual ``w`` plus the trainable low-rank adapter ``b_t``/``a_t``, whose
outputs the ``Linear`` sums. ``init_adapters`` returns the adapted copy of
the model and a mask marking the trainable adapter parameters by name.
lora draws ``b_t`` from a ``torch.Generator`` seeded with ``seed`` on the
model's device: jax.random's draws cannot be reproduced, so its invariants
are what carries over (``a_t = 0``, ``w`` unchanged, the scale of ``b_t``).
"""
from __future__ import annotations

import copy
import math
from typing import Dict

import torch

from repro_torch.core import baselines as bl
from repro_torch.core import coala as coala_lib
from repro_torch.core.compress import compressible
from repro_torch.models.linear import Linear


def _init_one(w, r_factor, method: str, rank: int, generator):
    """w: (d_in, d_out) storage view. Returns (w_res, b_t, a_t)."""
    d_in, d_out = w.shape
    w_mat = w.T.float()                                # (d_out, d_in)
    if method == "lora":
        a_t = torch.zeros((rank, d_out), dtype=w.dtype, device=w.device)
        b_t = (torch.randn((d_in, rank), generator=generator,
                           dtype=torch.float32, device=w.device)
               / math.sqrt(d_in)).to(w.dtype)
        return w, b_t, a_t
    if method == "pissa":
        eye = torch.eye(d_in, dtype=torch.float32, device=w.device)
        a, b = coala_lib.coala_alpha_factors(w_mat, r_factor=eye, rank=rank,
                                             alpha=0.0)
    elif method == "corda":
        a, b = bl.corda(w_mat, r_factor.T, rank)        # XXᵀ = RᵀR
    elif method.startswith("coala"):
        alpha = float(method.split("_a")[1]) if "_a" in method else 1.0
        a, b = coala_lib.coala_alpha_factors(w_mat, r_factor=r_factor,
                                             rank=rank, alpha=alpha)
    else:
        raise ValueError(method)
    a, b = coala_lib.balanced_split(a, b)
    w_res = (w_mat - a @ b).T.to(w.dtype)
    return w_res, b.T.to(w.dtype), a.T.to(w.dtype)


@torch.no_grad()
def init_adapters(model, r_factors: Dict[str, torch.Tensor], *, method: str,
                  rank: int, seed: int = 0):
    """Returns (adapted copy of ``model``, trainable mask) — the mask maps
    every parameter name to True on adapter leaves, False elsewhere.

    A target is every ``Linear`` holding ``w`` whose path ('blocks/2/sub0/
    mixer/wq', the calibrator's key) is compressible; lora and pissa take
    every target, the other methods those with an R factor. Each rep of the
    blocks gets its own subspace from its own R, as in the reference."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    new_model = copy.deepcopy(model)
    adapted = set()
    for name, lin in new_model.named_modules():
        if not (isinstance(lin, Linear) and lin.has_dense):
            continue
        p = name.replace(".", "/")
        if not compressible(tuple(p.split("/")), lin.w.shape):
            continue
        if method not in ("lora", "pissa") and p not in r_factors:
            continue
        rf = r_factors.get(p)
        w_res, b_t, a_t = _init_one(lin.w, None if rf is None else rf.float(),
                                    method, rank, gen)
        lin.set_adapter(w_res, b_t, a_t)
        adapted.add(name)
    mask = {k: k.endswith((".b_t", ".a_t")) and k.rsplit(".", 1)[0] in adapted
            for k, _ in new_model.named_parameters()}
    return new_model, mask


@torch.no_grad()
def merge_adapters(model):
    """A copy of ``model`` with b_t·a_t folded back into w (deployment form)."""
    merged = copy.deepcopy(model)
    for lin in merged.modules():
        if isinstance(lin, Linear) and lin.has_dense and lin.is_factored:
            lin.set_dense(lin.w + (lin.b_t @ lin.a_t).to(lin.w.dtype))
    return merged


def mask_grads(grads: Dict[str, torch.Tensor], mask: Dict[str, bool]
               ) -> Dict[str, torch.Tensor]:
    """Zero gradients on frozen leaves (adapter-only fine-tuning)."""
    return {k: g if mask[k] else torch.zeros_like(g) for k, g in grads.items()}

