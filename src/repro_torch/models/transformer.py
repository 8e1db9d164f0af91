"""Decoder-only LM for the attention-only families (port of
``repro/models/transformer.py:32-105``, ``:133-186`` and ``:208-504``):
dense GQA (llama, mistral, smollm, olmo's non-parametric norms, minicpm's
scaled embedding, residuals and logits, gemma2's local/global alternation,
softcaps and sandwich norms), deepseek's MoE (dense-FFN prefix layers,
then MoE FFNs) and deepseek-v2's MLA attention (``kv_lora_rank`` > 0).

``LM`` is an ``nn.Module`` with the reference's layer layout: ``prefix`` is
a ``ModuleList`` of the unrolled leading layers (deepseek's first dense-FFN
layer), ``blocks`` a ``ModuleList`` over the ``n_rep`` repetitions of the
layer period, each a ``ModuleDict`` of ``sub{j}`` blocks; a Python loop
over them replaces ``lax.scan``. The ``state_dict`` names are the JAX
parameter paths with ``/`` replaced by ``.`` (``blocks/3/sub0/mixer/wq/w``
-> ``blocks.3.sub0.mixer.wq.w``, ``prefix/0/ffn/up/w`` ->
``prefix.0.ffn.up.w``), which keeps ``convert.py`` mechanical. The serving
cache is a list with one dict of page stores per layer, prefix layers
first: ``{"k", "v"}`` (num_blocks, bs, Hkv, hd) for GQA, the latents
``{"c": (num_blocks, bs, kv_lora_rank), "k_rope": (num_blocks, bs,
qk_rope_dim)}`` for MLA.

Every parameter is trainable (``LM.loss`` under autograd); the inference
entry points run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.attention import GQA, MLA
from repro_torch.models.common import (CPU_CTX, ParallelCtx, dense_init,
                                       make_norm, rope_cos_sin, softcap)
from repro_torch.models.ffn import MLP, ExpertBank, MoE
from repro_torch.models.linear import Linear


def chunked_ce(h, targets, head_w, *, transform: Optional[Callable] = None,
               chunk: int = 512):
    """Mean next-token cross-entropy without materializing (B, T, vocab)
    logits: the sequence is cut into ``chunk``-token pieces (the tail padded
    and masked, so any T works), each piece's fp32 logits against the head
    reduced to scalars at once."""
    b, t, _ = h.shape
    ck = min(chunk, t)
    pad = (-t) % ck
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    mask = (torch.arange(t + pad, device=h.device) < t).float()
    w = head_w.to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, t + pad, ck):
        logits = (h[:, c0:c0 + ck] @ w).float()
        if transform is not None:
            logits = transform(logits)
        lse = torch.logsumexp(logits, dim=-1)
        y = targets[:, c0:c0 + ck].long()
        gold = torch.gather(logits, -1, y[..., None])[..., 0]
        m_c = mask[c0:c0 + ck]
        tot = tot + torch.sum((lse - gold) * m_c[None, :])
        cnt = cnt + b * torch.sum(m_c)
    return tot / cnt


@dataclasses.dataclass(frozen=True)
class SubSpec:
    is_moe: bool
    is_local: bool


def period_specs(cfg: ModelConfig):
    """(prefix_specs, period_specs, n_rep): ``first_k_dense`` unrolled
    layers, then a period repeated ``n_rep`` times. The pattern must be
    periodic."""
    n = cfg.n_layers

    def spec(i):
        return SubSpec(cfg.layer_is_moe(i), cfg.layer_is_local_attn(i))

    base = cfg.first_k_dense
    rest = n - base
    # period length: lcm of the pattern generators present
    p = 1
    if cfg.local_window > 0:
        p = max(p, 2)
    if cfg.uses_moe and cfg.moe_every > 1:
        p = max(p, cfg.moe_every)
    while rest % p:
        p += 1                      # fall back to a longer period that divides
    for i in range(base, n):
        a, b = spec(i), spec(base + (i - base) % p)
        if a != b:
            raise ValueError(f"layer pattern not periodic: layer {i} {a} != {b}")
    return ([spec(i) for i in range(base)],
            [spec(base + j) for j in range(p)], rest // p)


class Block(torch.nn.Module):
    """Pre-norm attention + FFN (gated MLP or MoE), both residual, each
    branch scaled by ``scale_depth / sqrt(n_layers)`` (minicpm) and, with
    ``post_block_norm`` (gemma2), normed before its residual add."""

    def __init__(self, cfg: ModelConfig, spec: SubSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.local = spec.is_local
        self.res_scale = (cfg.scale_depth / math.sqrt(cfg.n_layers)
                          if cfg.scale_depth else 1.0)
        self.norm1 = make_norm(cfg, **kw)
        self.mixer = MLA(cfg, **kw) if cfg.kv_lora_rank else GQA(cfg, **kw)
        self.norm2 = make_norm(cfg, **kw)
        self.is_moe = spec.is_moe
        self.ffn = (MoE(cfg, **kw) if spec.is_moe
                    else MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw))
        self.post = cfg.post_block_norm
        if self.post:
            self.post1 = make_norm(cfg, **kw)
            self.post2 = make_norm(cfg, **kw)

    def forward(self, x, cos_sin, **attn_kw):
        """Returns (x, aux): the MoE's weighted aux loss, None for an MLP."""
        h = self.mixer(self.norm1(x), cos_sin, local=self.local, **attn_kw)
        if self.post:
            h = self.post1(h)
        x = x + self.res_scale * h
        aux = None
        if self.is_moe:
            h, aux = self.ffn(self.norm2(x))
        else:
            h = self.ffn(self.norm2(x))
        if self.post:
            h = self.post2(h)
        return x + self.res_scale * h, aux


class LM(torch.nn.Module):
    """Attention-only decoder: training loss, calibration forward, batched
    paged prefill and paged decode."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense and moe only)")
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.zeros((cfg.vocab_size, cfg.d_model), **kw))
        self.final_norm = make_norm(cfg, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, **kw)
        prefix, period, n_rep = period_specs(cfg)
        self.prefix = torch.nn.ModuleList([Block(cfg, spec, **kw)
                                           for spec in prefix])
        self.blocks = torch.nn.ModuleList([
            torch.nn.ModuleDict({f"sub{j}": Block(cfg, spec, **kw)
                                 for j, spec in enumerate(period)})
            for _ in range(n_rep)])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def layers(self):
        """The decoder blocks in depth order, prefix layers first."""
        yield from self.prefix
        for rep in self.blocks:
            yield from rep.values()

    # ---------------- params ------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random init in place, from ``generator`` (on the model's device):
        embeddings N(0, 0.02²), projections (MLA's ``w_uk``/``w_uv`` too),
        routers and expert banks N(0, 1/d_in), norm scales 0."""
        self.embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
        for mod in self.modules():
            if isinstance(mod, Linear):
                dense_init(mod.w, generator)
            elif isinstance(mod, MLA):
                dense_init(mod.w_uk, generator)
                dense_init(mod.w_uv, generator)
            elif isinstance(mod, MoE):
                dense_init(mod.router, generator)
            elif isinstance(mod, ExpertBank):
                mod.w.normal_(0.0, 1.0, generator=generator).mul_(
                    1.0 / math.sqrt(mod.w.shape[1]))
        return self

    # ---------------- caches -----------------------------------------------
    def init_cache(self, num_blocks: int, block_size: int,
                   dtype=torch.float32) -> List[dict]:
        """Per-layer page stores: {"k", "v"} (num_blocks, bs, Hkv, hd), or
        MLA's latents {"c": (num_blocks, bs, kv_lora_rank), "k_rope":
        (num_blocks, bs, qk_rope_dim)}."""
        cfg = self.cfg
        nb, bs = num_blocks, block_size
        if cfg.kv_lora_rank:
            shapes = {"c": (nb, bs, cfg.kv_lora_rank),
                      "k_rope": (nb, bs, cfg.qk_rope_dim)}
        else:
            kv = (nb, bs, cfg.n_kv_heads, cfg.head_dim)
            shapes = {"k": kv, "v": kv}
        return [{name: torch.zeros(shape, dtype=dtype, device=self.device)
                 for name, shape in shapes.items()}
                for _ in range(cfg.n_layers)]

    # ---------------- backbone ----------------------------------------------
    def _backbone(self, tokens, *, ctx: ParallelCtx = CPU_CTX,
                  compute_dtype=None, cache=None, pos=None, paged_tables=None,
                  lens=None):
        """Final-normed hidden states and the summed MoE aux loss."""
        cfg = self.cfg
        x = self.embed[tokens.long()]
        if cfg.scale_emb != 1.0:
            x = x * cfg.scale_emb
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        t = tokens.shape[1]
        ar = torch.arange(t, device=self.device)
        positions = ar if pos is None else pos.long()[:, None] + ar
        rope_dim = cfg.qk_rope_dim if cfg.kv_lora_rank else cfg.head_dim
        cos_sin = rope_cos_sin(positions, rope_dim, cfg.rope_theta)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, blk in enumerate(self.layers()):
            x, aux = blk(x, cos_sin, cache=None if cache is None else cache[i],
                         pos=pos, paged_tables=paged_tables, lens=lens, ctx=ctx)
            if aux is not None:
                aux_total = aux_total + aux
        return self.final_norm(x), aux_total

    def _head_w(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head.w

    def _logit_transform(self, logits):
        """minicpm's d_model/dim_model_base division, then the final softcap."""
        cfg = self.cfg
        if cfg.dim_model_base:
            logits = logits / (cfg.d_model / cfg.dim_model_base)
        return softcap(logits, cfg.final_logit_softcap)

    def _logits(self, h):
        return self._logit_transform((h @ self._head_w().to(h.dtype)).float())

    # ---------------- public: train loss ------------------------------------
    def loss(self, tokens, *, ctx: ParallelCtx = CPU_CTX, loss_chunk: int = 512,
             compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``tokens`` (B, T) with activations in
        ``compute_dtype``; returns ``(ce + aux, {"ce", "aux"})`` (aux is the
        MoE layers' weighted load-balance loss, 0 for dense models).
        Differentiable unless ``ctx`` selects the flash kernel, which has no
        backward: evaluate that under ``no_grad``."""
        h, aux = self._backbone(tokens, ctx=ctx, compute_dtype=compute_dtype)
        ce = chunked_ce(h[:, :-1], tokens[:, 1:], self._head_w(),
                        transform=self._logit_transform, chunk=loss_chunk)
        return ce + aux, {"ce": ce, "aux": aux}

    # ---------------- public: inference --------------------------------------
    @torch.no_grad()
    def logits(self, tokens):
        """Full-sequence causal logits (B, T, vocab) without a cache."""
        return self._logits(self._backbone(tokens)[0])

    @torch.no_grad()
    def capture_forward(self, tokens, calibrator, *,
                        ctx: ParallelCtx = CPU_CTX,
                        compute_dtype=torch.float32):
        """Forward that streams every target linear's input activations into
        ``calibrator`` (per-layer R factors, never X), activations in
        ``compute_dtype``. Returns the final hidden states."""
        with calibrator.capture(self):
            return self._backbone(tokens, ctx=ctx,
                                  compute_dtype=compute_dtype)[0]

    @torch.no_grad()
    def capture_prefill(self, tokens, calibrator, *,
                        ctx: ParallelCtx = CPU_CTX,
                        compute_dtype=torch.float32):
        """Capture hook of the serving path (``repro/models/transformer.py:
        406-420``): one request's token stream ``tokens`` (T,) as a (1, T)
        batch through ``capture_forward``. Causality makes it the exact
        replay of what serving computed: position p depends only on tokens
        <= p, so a calibrator recording positions [start, T) sees the rows
        a live prefill and decode over them produced (``serve/recalibrate.py``
        slices in its ``record`` override)."""
        tokens = torch.as_tensor(tokens, device=self.device).reshape(1, -1)
        return self.capture_forward(tokens, calibrator, ctx=ctx,
                                    compute_dtype=compute_dtype)

    @torch.no_grad()
    def prefill_chunk(self, tokens, cache, pos, lens, block_tables, *,
                      compute_dtype=None):
        """Prefill a batch of suffix chunks at per-request cache offsets.

        tokens (B, L) int — row i's un-cached prompt suffix right-padded to
        the length bucket L; pos (B,) int32 start offsets; lens (B,) int32
        valid tokens per row; block_tables (B, nb) int32. The suffix K/V are
        written into the page stores of ``cache`` in place, in the stores'
        dtype; activations are in ``compute_dtype`` (None: the embedding's).
        Returns the logits at each row's last valid token, (B, vocab)."""
        h, _ = self._backbone(tokens, compute_dtype=compute_dtype, cache=cache,
                              pos=pos, paged_tables=block_tables, lens=lens)
        idx = torch.clamp(lens.long() - 1, min=0)
        h_last = h[torch.arange(h.shape[0], device=h.device), idx]
        return self._logits(h_last)

    @torch.no_grad()
    def verify_chunk(self, tokens, cache, pos, lens, block_tables, *,
                     compute_dtype=None):
        """Speculative-decoding verifier (``repro/models/transformer.py:464``):
        ``prefill_chunk`` returning the logits at every position, (B, L,
        vocab). Row i is ``[last emitted token, d_1 .. d_{L-1}]`` at offset
        ``pos[i]`` (the request's cache length), so ``logits[:, j]`` is the
        target's next-token distribution after position ``pos + j``, which
        accept/reject compares with proposal ``d_{j+1}``."""
        h, _ = self._backbone(tokens, compute_dtype=compute_dtype, cache=cache,
                              pos=pos, paged_tables=block_tables, lens=lens)
        return self._logits(h)

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos, block_tables, *,
                    compute_dtype=None):
        """tokens (B, 1); pos (B,) int32 positions being written; returns the
        next-token logits (B, vocab) and writes K/V into the pages."""
        h, _ = self._backbone(tokens, compute_dtype=compute_dtype, cache=cache,
                              pos=pos, paged_tables=block_tables)
        return self._logits(h)[:, 0]
