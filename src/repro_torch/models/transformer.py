"""Decoder-only LM for the dense GQA families (port of
``repro/models/transformer.py:32-60`` and ``:208-504``).

``LM`` is an ``nn.Module`` whose ``blocks`` is a ``ModuleList`` over the
``n_rep`` repetitions of the layer period, each a ``ModuleDict`` of
``sub{j}`` blocks; a Python loop over them replaces ``lax.scan``. The
``state_dict`` names are the JAX parameter paths with ``/`` replaced by
``.`` (``blocks/3/sub0/mixer/wq/w`` -> ``blocks.3.sub0.mixer.wq.w``), which
keeps ``convert.py`` mechanical. The serving cache is a list with one
``{"k", "v"}`` page-store pair (num_blocks, bs, Hkv, hd) per layer.

Every parameter is trainable (``LM.loss`` under autograd); the inference
entry points run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.attention import GQA
from repro_torch.models.common import (CPU_CTX, ParallelCtx, dense_init,
                                       make_norm, rope_cos_sin, softcap)
from repro_torch.models.ffn import MLP
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


def period_specs(cfg: ModelConfig) -> Tuple[List[bool], int]:
    """(per-sub-block ``is_local`` flags of one period, n_rep)."""
    p = 2 if cfg.local_window > 0 else 1
    while cfg.n_layers % p:
        p += 1
    return [cfg.layer_is_local_attn(j) for j in range(p)], cfg.n_layers // p


class Block(torch.nn.Module):
    """Pre-norm attention + gated MLP, both residual."""

    def __init__(self, cfg: ModelConfig, local: bool, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.local = local
        self.norm1 = make_norm(cfg, **kw)
        self.mixer = GQA(cfg, **kw)
        self.norm2 = make_norm(cfg, **kw)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)

    def forward(self, x, cos_sin, **attn_kw):
        x = x + self.mixer(self.norm1(x), cos_sin, local=self.local, **attn_kw)
        return x + self.ffn(self.norm2(x))


class LM(torch.nn.Module):
    """Dense GQA decoder: calibration forward, batched paged prefill and
    paged decode."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.zeros((cfg.vocab_size, cfg.d_model), **kw))
        self.final_norm = make_norm(cfg, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, **kw)
        period, n_rep = period_specs(cfg)
        self.blocks = torch.nn.ModuleList([
            torch.nn.ModuleDict({f"sub{j}": Block(cfg, local, **kw)
                                 for j, local in enumerate(period)})
            for _ in range(n_rep)])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def layers(self):
        """The decoder blocks in depth order."""
        for rep in self.blocks:
            yield from rep.values()

    # ---------------- params ------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random init in place, from ``generator`` (on the model's device):
        embeddings N(0, 0.02²), projections N(0, 1/d_in), norm scales 0."""
        self.embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
        for mod in self.modules():
            if isinstance(mod, Linear):
                dense_init(mod.w, generator)
        return self

    # ---------------- caches -----------------------------------------------
    def init_cache(self, num_blocks: int, block_size: int,
                   dtype=torch.float32) -> List[dict]:
        """Per-layer page stores {"k", "v"}: (num_blocks, bs, Hkv, hd)."""
        cfg = self.cfg
        shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(cfg.n_layers)]

    # ---------------- backbone ----------------------------------------------
    def _backbone(self, tokens, *, ctx: ParallelCtx = CPU_CTX,
                  compute_dtype=None, cache=None, pos=None, paged_tables=None,
                  lens=None):
        cfg = self.cfg
        x = self.embed[tokens.long()]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        t = tokens.shape[1]
        ar = torch.arange(t, device=self.device)
        positions = ar if pos is None else pos.long()[:, None] + ar
        cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        for i, blk in enumerate(self.layers()):
            x = blk(x, cos_sin, cache=None if cache is None else cache[i],
                    pos=pos, paged_tables=paged_tables, lens=lens, ctx=ctx)
        return self.final_norm(x)

    def _head_w(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head.w

    def _logits(self, h):
        logits = (h @ self._head_w().to(h.dtype)).float()
        return softcap(logits, self.cfg.final_logit_softcap)

    # ---------------- public: train loss ------------------------------------
    def loss(self, tokens, *, ctx: ParallelCtx = CPU_CTX, loss_chunk: int = 512,
             compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``tokens`` (B, T) with activations in
        ``compute_dtype``; returns ``(ce + aux, {"ce", "aux"})`` (aux is 0
        for dense models). Differentiable unless ``ctx`` selects the flash
        kernel, which has no backward: evaluate that under ``no_grad``."""
        h = self._backbone(tokens, ctx=ctx, compute_dtype=compute_dtype)
        cap = self.cfg.final_logit_softcap
        ce = chunked_ce(h[:, :-1], tokens[:, 1:], self._head_w(),
                        transform=lambda lg: softcap(lg, cap),
                        chunk=loss_chunk)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    # ---------------- public: inference --------------------------------------
    @torch.no_grad()
    def logits(self, tokens):
        """Full-sequence causal logits (B, T, vocab) without a cache."""
        return self._logits(self._backbone(tokens))

    @torch.no_grad()
    def capture_forward(self, tokens, calibrator, *,
                        ctx: ParallelCtx = CPU_CTX,
                        compute_dtype=torch.float32):
        """Forward that streams every target linear's input activations into
        ``calibrator`` (per-layer R factors, never X), activations in
        ``compute_dtype``. Returns the final hidden states."""
        with calibrator.capture(self):
            return self._backbone(tokens, ctx=ctx, compute_dtype=compute_dtype)

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
        h = self._backbone(tokens, compute_dtype=compute_dtype, cache=cache,
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
        h = self._backbone(tokens, compute_dtype=compute_dtype, cache=cache,
                           pos=pos, paged_tables=block_tables, lens=lens)
        return self._logits(h)

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos, block_tables, *,
                    compute_dtype=None):
        """tokens (B, 1); pos (B,) int32 positions being written; returns the
        next-token logits (B, vocab) and writes K/V into the pages."""
        h = self._backbone(tokens, compute_dtype=compute_dtype, cache=cache,
                           pos=pos, paged_tables=block_tables)
        return self._logits(h)[:, 0]
