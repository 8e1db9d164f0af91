"""Whisper-style encoder–decoder (port of ``repro/models/encdec.py``).

The modality frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings ``frames`` (B, n_audio_frames, d_model). The
backbone is real: an encoder of non-causal self-attention over sinusoidal
positions, then a decoder over learned positions (``pos_dec``) whose layers
run causal self-attention, cross-attention to the encoder outputs and a
gelu MLP without a gate, each pre-normed (RMSNorm at eps 1e-6, the
reference's default here) and residual. The output head is the embedding,
transposed (whisper ties them).

``EncDecLM`` keeps the reference's parameter paths: ``enc`` and ``dec`` are
``ModuleList``s over the layers the JAX tree stacks, with the leaves
``norm1``/``attn``/``norm2``/``mlp`` in an encoder layer and
``norm1``/``self``/``norm2``/``cross``/``norm3``/``mlp`` in a decoder layer,
so ``enc/2/attn/wq`` is ``enc.2.attn.wq.w`` here and the calibrator's paths
are the reference's.

Caches. A decoder layer's cache is one dict: self-attention K/V ``{"k",
"v"}`` and the cross K/V ``{"ck", "cv"}`` (·, n_audio_frames, Hkv, hd)
that ``cross_cache_from_encoder`` computes once per request. In the
contiguous cache (``init_contiguous_cache``, the reference's ``init_cache``)
every leaf is (batch, ...). In the serving pool (``init_cache``) ``k``/``v``
are page stores (num_blocks, bs, Hkv, hd), written and read through block
tables (the paged-attention kernel on the card), and ``ck``/``cv`` are
per-request slot stores (n_slots, n_audio_frames, Hkv, hd), gathered at
every decode step from the batch's ``slots`` and never written back: cross
K/V are read-only once prefilled.

The encoder's attention is never causal, so it never takes the flash
kernel; the decoder's causal self-attention does, under ``ctx.use_pallas``,
in the loss, calibration and prefill, as in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.attention import (GQA, CrossAttention,
                                          cross_cache_from_encoder)
from repro_torch.models.common import (CPU_CTX, ParallelCtx, RMSNorm,
                                       dense_init, rematerialize)
from repro_torch.models.ffn import MLP
from repro_torch.models.linear import Linear
from repro_torch.models.transformer import chunked_ce

NORM_EPS = 1e-6                  # the reference's rmsnorm default


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's encoder positions (length, channels): sin | cos."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


class EncoderLayer(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        self.attn = GQA(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", glu=False, **kw)

    def forward(self, x, *, ctx: ParallelCtx = CPU_CTX):
        x = x + self.attn(self.norm1(x), None, causal=False, ctx=ctx)
        return x + self.mlp(self.norm2(x))


class DecoderLayer(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        self.self = GQA(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        self.cross = CrossAttention(cfg, **kw)
        self.norm3 = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", glu=False, **kw)

    def forward(self, x, *, enc_out=None, cache=None, pos=None,
                paged_tables=None, slots=None, ctx: ParallelCtx = CPU_CTX):
        """Without ``pos`` the cross K/V come from ``enc_out`` (and, with a
        contiguous ``cache``, are kept in it); decoding (``pos`` given) they
        are the cache's rows, or its ``slots`` rows in the pool."""
        x = x + self.self(self.norm1(x), None, cache=cache, pos=pos,
                          paged_tables=paged_tables, ctx=ctx)
        if pos is None:
            kv = cross_cache_from_encoder(self.cross, enc_out)
            if cache is not None:              # prefill: fill the cross cache
                cache["ck"].copy_(kv["ck"])
                cache["cv"].copy_(kv["cv"])
            ck, cv = kv["ck"], kv["cv"]
        elif slots is None:
            ck, cv = cache["ck"], cache["cv"]
        else:
            ck = cache["ck"].index_select(0, slots)
            cv = cache["cv"].index_select(0, slots)
        x = x + self.cross(self.norm2(x), ck, cv, ctx=ctx)
        return x + self.mlp(self.norm3(x))


class EncDecLM(torch.nn.Module):
    """Encoder–decoder LM: training loss, calibration forward, a prefill and
    decode over a contiguous cache, and decode over the serving pool's pages
    and slots."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM needs family 'encdec', not "
                             f"{cfg.family!r}")
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.zeros((cfg.vocab_size, cfg.d_model), **kw))
        self.pos_dec = torch.nn.Parameter(
            torch.zeros((cfg.max_seq_len, cfg.d_model), **kw))
        self.enc_final_norm = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        self.dec_final_norm = RMSNorm(cfg.d_model, NORM_EPS, **kw)
        n_enc = cfg.n_enc_layers or cfg.n_layers
        self.enc = torch.nn.ModuleList([EncoderLayer(cfg, **kw)
                                        for _ in range(n_enc)])
        self.dec = torch.nn.ModuleList([DecoderLayer(cfg, **kw)
                                        for _ in range(cfg.n_layers)])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def layer_kinds(self) -> List[str]:
        """One 'cross' per decoder layer (the serving cache's layers): its
        self-attention K/V in token pages, its cross K/V as per-request
        state."""
        return ["cross"] * len(self.dec)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random init in place from ``generator``: the embedding and
        ``pos_dec`` N(0, 0.02²), projections N(0, 1/d_in), norm scales 0."""
        for p in (self.embed, self.pos_dec):
            p.normal_(0.0, 1.0, generator=generator).mul_(0.02)
        for mod in self.modules():
            if isinstance(mod, Linear):
                dense_init(mod.w, generator)
        return self

    # ---------------- caches -----------------------------------------------
    def init_cache(self, num_blocks: int, block_size: int,
                   dtype=torch.float32, *, slots: int = 0) -> List[dict]:
        """Per decoder layer: page stores ``k``/``v`` (num_blocks,
        block_size, Hkv, hd) and slot stores ``ck``/``cv`` (slots,
        n_audio_frames, Hkv, hd), zeros in ``dtype``."""
        return self._cache_stores((num_blocks, block_size), (slots,), dtype)

    def init_contiguous_cache(self, batch: int, max_len: int,
                              dtype=torch.float32) -> List[dict]:
        """The JAX ``EncDecLM.init_cache(batch, max_len)``: per decoder
        layer ``k``/``v`` (batch, max_len, Hkv, hd) and ``ck``/``cv``
        (batch, n_audio_frames, Hkv, hd), zeros in ``dtype``."""
        return self._cache_stores((batch, max_len), (batch,), dtype)

    def _cache_stores(self, lead: tuple, state_lead: tuple, dtype
                      ) -> List[dict]:
        cfg = self.cfg
        head = (cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": lead + head, "v": lead + head,
                  "ck": state_lead + (cfg.n_audio_frames,) + head,
                  "cv": state_lead + (cfg.n_audio_frames,) + head}
        return [{n: torch.zeros(s, dtype=dtype, device=self.device)
                 for n, s in shapes.items()} for _ in self.dec]

    # ---------------- backbone ----------------------------------------------
    def encode(self, frames, *, ctx: ParallelCtx = CPU_CTX):
        """Encoder outputs (B, S, d_model) of ``frames`` (B, S, d_model),
        in frames' dtype."""
        x = frames + sinusoids(frames.shape[1], self.cfg.d_model,
                               device=frames.device).to(frames.dtype)
        for layer in self.enc:
            x = layer(x, ctx=ctx)
        return self.enc_final_norm(x)

    def _embed_dec(self, tokens, pos0):
        """Token embeddings plus ``pos_dec`` rows pos0 .. pos0 + T - 1
        (``pos0`` a scalar or (B,) per row), the start clamped to the
        table's end as the reference's ``dynamic_slice`` clamps it."""
        t = tokens.shape[1]
        x = self.embed[tokens.long()]
        last = self.cfg.max_seq_len - t
        if torch.is_tensor(pos0) and pos0.ndim == 1:
            start = torch.clamp(pos0.long(), 0, last)
            pe = self.pos_dec[start[:, None]
                              + torch.arange(t, device=tokens.device)]
        else:
            start = min(max(int(pos0), 0), last)
            pe = self.pos_dec[start:start + t][None]
        return x + pe

    def _frames(self, frames, dtype):
        return torch.as_tensor(frames, device=self.device).to(dtype)

    def _decoder(self, x, *, enc_out=None, cache=None, pos=None,
                 paged_tables=None, slots=None, ctx: ParallelCtx = CPU_CTX,
                 remat: str = "none"):
        """Final-normed decoder states of the embedded tokens ``x``.
        ``remat`` (``common.rematerialize``) applies to each decoder layer,
        the reference's scanned body; the encoder is not rematerialized, as
        in the reference."""
        if slots is not None:
            slots = slots.long()
        for i, layer in enumerate(self.dec):
            x = rematerialize(functools.partial(
                layer, enc_out=enc_out, cache=None if cache is None else cache[i],
                pos=pos, paged_tables=paged_tables, slots=slots, ctx=ctx), remat, x)
        return self.dec_final_norm(x)

    def _logits(self, h):
        return (h @ self.embed.T.to(h.dtype)).float()

    # ---------------- public: train loss ------------------------------------
    def loss(self, tokens, *, frames, ctx: ParallelCtx = CPU_CTX,
             remat: str = "none", loss_chunk: int = 512,
             compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``tokens`` (B, T) given ``frames`` (B, S,
        d_model), activations in ``compute_dtype``; returns ``(ce, {"ce",
        "aux"})`` with aux 0. ``remat`` rematerializes each decoder layer in
        the backward (``_decoder``). Differentiable unless ``ctx`` selects
        the flash kernel, which has no backward."""
        enc_out = self.encode(self._frames(frames, compute_dtype), ctx=ctx)
        x = self._embed_dec(tokens, 0).to(compute_dtype)
        h = self._decoder(x, enc_out=enc_out, ctx=ctx, remat=remat)
        ce = chunked_ce(h[:, :-1], tokens[:, 1:], self.embed.T,
                        chunk=loss_chunk)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=self.device)}

    # ---------------- public: inference --------------------------------------
    @torch.no_grad()
    def capture_forward(self, tokens, calibrator, *, frames,
                        ctx: ParallelCtx = CPU_CTX,
                        compute_dtype=torch.float32):
        """Forward that streams every target linear's inputs into
        ``calibrator``: the encoder's under ``enc/{i}/...``, the decoder's
        under ``dec/{i}/self/...`` and ``dec/{i}/cross/...``, where the
        cross ``wk``/``wv`` see the encoder outputs as X (the reference's
        ``capture_forward``). Returns the final decoder states."""
        with calibrator.capture(self):
            enc_out = self.encode(self._frames(frames, compute_dtype), ctx=ctx)
            x = self._embed_dec(tokens, 0).to(compute_dtype)
            return self._decoder(x, enc_out=enc_out, ctx=ctx)

    @torch.no_grad()
    def prefill(self, tokens, cache, *, frames, ctx: ParallelCtx = CPU_CTX,
                compute_dtype=None):
        """Prefill a contiguous cache from ``init_contiguous_cache``: encode
        ``frames`` (B, S, d_model), then tokens (B, T) fill the self K/V at
        [0, T) and every layer's cross K/V, in the cache's dtype;
        activations in ``compute_dtype`` (None: the embedding's). Returns
        the logits at the last position, (B, vocab)."""
        cd = compute_dtype or self.dtype
        enc_out = self.encode(self._frames(frames, cd), ctx=ctx)
        x = self._embed_dec(tokens, 0).to(cd)
        h = self._decoder(x, enc_out=enc_out, cache=cache, ctx=ctx)
        return self._logits(h[:, -1])

    @torch.no_grad()
    def decode_step(self, tokens, cache, pos, block_tables=None, *,
                    slots=None, compute_dtype=None):
        """tokens (B, 1); returns the next-token logits (B, vocab). With
        ``block_tables`` (B, nb): pos (B,) int32 positions, self K/V written
        into the pages of ``cache`` and read through the paged-attention
        kernel, cross K/V gathered from the rows ``slots`` (B,) of the slot
        stores. Without: ``cache`` is contiguous and pos one scalar position
        of every row."""
        cd = compute_dtype or self.dtype
        x = self._embed_dec(tokens, pos).to(cd)
        h = self._decoder(x, cache=cache, pos=pos, paged_tables=block_tables,
                          slots=slots)
        return self._logits(h)[:, 0]
