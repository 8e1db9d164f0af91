"""Decoder-only LM for the dense GQA families (port of
``repro/models/transformer.py:208-504``).

``LM`` is an ``nn.Module`` whose ``blocks`` is a ``ModuleList`` over the
``n_rep`` repetitions of the layer period, each a ``ModuleDict`` of
``sub{j}`` blocks; a Python loop over them replaces ``lax.scan``. The
``state_dict`` names are the JAX parameter paths with ``/`` replaced by
``.`` (``blocks/3/sub0/mixer/wq/w`` -> ``blocks.3.sub0.mixer.wq.w``), which
keeps ``convert.py`` mechanical. The serving cache is a list with one
``{"k", "v"}`` page-store pair (num_blocks, bs, Hkv, hd) per layer.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.attention import GQA
from repro_torch.models.common import (dense_init, make_norm, rope_cos_sin,
                                       softcap)
from repro_torch.models.ffn import MLP
from repro_torch.models.linear import Linear


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
            torch.zeros((cfg.vocab_size, cfg.d_model), **kw),
            requires_grad=False)
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
    def _backbone(self, tokens, *, cache=None, pos=None, paged_tables=None,
                  lens=None):
        cfg = self.cfg
        x = self.embed[tokens.long()]
        t = tokens.shape[1]
        ar = torch.arange(t, device=self.device)
        positions = ar if pos is None else pos.long()[:, None] + ar
        cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        for i, blk in enumerate(self.layers()):
            x = blk(x, cos_sin, cache=None if cache is None else cache[i],
                    pos=pos, paged_tables=paged_tables, lens=lens)
        return self.final_norm(x)

    def _logits(self, h):
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head.w
        logits = (h @ w.to(h.dtype)).float()
        return softcap(logits, self.cfg.final_logit_softcap)

    # ---------------- public -------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens):
        """Full-sequence causal logits (B, T, vocab) without a cache."""
        return self._logits(self._backbone(tokens))

    @torch.no_grad()
    def capture_forward(self, tokens, calibrator):
        """Forward that streams every target linear's input activations into
        ``calibrator`` (per-layer R factors, never X). Returns the final
        hidden states."""
        with calibrator.capture(self):
            return self._backbone(tokens)

    @torch.no_grad()
    def prefill_chunk(self, tokens, cache, pos, lens, block_tables):
        """Prefill a batch of suffix chunks at per-request cache offsets.

        tokens (B, L) int — row i's un-cached prompt suffix right-padded to
        the length bucket L; pos (B,) int32 start offsets; lens (B,) int32
        valid tokens per row; block_tables (B, nb) int32. The suffix K/V are
        written into the page stores of ``cache`` in place. Returns the
        logits at each row's last valid token, (B, vocab)."""
        h = self._backbone(tokens, cache=cache, pos=pos,
                           paged_tables=block_tables, lens=lens)
        idx = torch.clamp(lens.long() - 1, min=0)
        h_last = h[torch.arange(h.shape[0], device=h.device), idx]
        return self._logits(h_last)

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos, block_tables):
        """tokens (B, 1); pos (B,) int32 positions being written; returns the
        next-token logits (B, vocab) and writes K/V into the pages."""
        h = self._backbone(tokens, cache=cache, pos=pos,
                           paged_tables=block_tables)
        return self._logits(h)[:, 0]
