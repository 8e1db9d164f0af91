"""GQA and MLA attention (port of ``repro/models/attention.py:196-294`` and
``:298-359``).

Two execution paths:
  * contiguous — ``sdpa`` over the whole sequence, causal: the training
    loss, evaluation and the calibration forward (``LM.capture_forward``).
    With ``ctx.use_pallas`` it runs ``ops.flash_attention`` (the CUDA flash
    kernel on a CUDA tensor), else the masked einsum ``dense_sdpa``;
  * paged — serving: the cache is the pool's page stores (num_blocks, bs,
    Hkv, hd). The new K/V are written into their pages in place
    (``index_put_`` where the JAX package uses ``.at[blk, p % bs].set`` on
    donated buffers), then ``ops.paged_attention`` attends for a decode step
    (t == 1) and ``ops.chunked_prefill`` for a batched suffix prefill (t > 1).

``MLA`` (deepseek-v2) keeps a latent cache, ``{"c": (num_blocks, bs,
kv_lora_rank), "k_rope": (num_blocks, bs, qk_rope_dim)}`` per layer, and
never the per-head K/V: without a cache it expands K/V from the latents and
runs ``sdpa`` (the flash kernel under ``use_pallas``, at head dim
nope + rope with V zero-padded to it); paged, it writes the new latents
into their pages and attends in latent space through the absorbed
``w_uk``/``w_uv`` over the row's pages read through its block table, in
plain torch, as the JAX package computes it in XLA einsums outside any
Pallas kernel. It never calls the paged kernels, whose pages are K/V.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import CPU_CTX, ParallelCtx, apply_rope, softcap
from repro_torch.models.linear import Linear

NEG_INF = -1e30


def dense_sdpa(q, k, v, *, causal: bool, window: int, cap: float, scale):
    """Causal (optionally windowed/softcapped) attention over contiguous
    q (B, Tq, Hq, hd), k/v (B, Tk, Hkv, hd), queries at positions 0..Tq-1."""
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, tq, hkv, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    s = softcap(s, cap)
    d = (torch.arange(tq, device=q.device)[:, None]
         - torch.arange(tk, device=q.device)[None, :])
    ok = torch.ones_like(d, dtype=torch.bool)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    s = s + torch.where(ok, zero, torch.full_like(zero, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(b, tq, hq, hd)


def sdpa(q, k, v, *, ctx: ParallelCtx, causal: bool = True, window: int = 0,
         cap: float = 0.0, scale=None):
    """Attention over a contiguous sequence: the flash kernel under exactly
    the JAX package's condition (``ctx.use_pallas``, causal, Tq == Tk, no
    window; ``repro/models/attention.py:201-204``), else ``dense_sdpa``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if ctx.use_pallas and causal and q.shape[1] == k.shape[1] and window == 0:
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), scale=scale, cap=cap)
    return dense_sdpa(q, k, v, causal=causal, window=window, cap=cap,
                      scale=scale)


class GQA(torch.nn.Module):
    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = Linear(d, cfg.n_heads * hd, **kw)
        self.wk = Linear(d, cfg.n_kv_heads * hd, **kw)
        self.wv = Linear(d, cfg.n_kv_heads * hd, **kw)
        self.wo = Linear(cfg.n_heads * hd, d, **kw)

    def forward(self, x, cos_sin, *, local: bool = False, cache=None,
                pos=None, paged_tables=None, lens=None,
                ctx: ParallelCtx = CPU_CTX):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).reshape(b, t, cfg.n_heads, hd)
        k = self.wk(x).reshape(b, t, cfg.n_kv_heads, hd)
        v = self.wv(x).reshape(b, t, cfg.n_kv_heads, hd)
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        window = cfg.local_window if local else 0
        scale = cfg.query_scale if cfg.query_scale > 0 else 1.0 / (hd ** 0.5)
        if paged_tables is None:
            o = sdpa(q, k, v, ctx=ctx, causal=True, window=window,
                     cap=cfg.attn_logit_softcap, scale=scale)
        else:
            # paged serving: write row i's t tokens at positions pos[i] + j
            # into their pages (padded tail tokens land in the row's last
            # partial page or the trash page, hidden by the causal masks
            # until a later decode overwrites them), then attend through the
            # block-table indirection
            kp, vp = cache["k"], cache["v"]
            bs = kp.shape[1]
            p = pos.long()[:, None] + torch.arange(t, device=x.device)
            blk = torch.gather(paged_tables.long(), 1, p // bs)
            kp.index_put_((blk, p % bs), k.to(kp.dtype))
            vp.index_put_((blk, p % bs), v.to(vp.dtype))
            if t == 1:
                o = ops.paged_attention(
                    q[:, 0].contiguous(), kp, vp, paged_tables, pos + 1,
                    scale=scale, cap=cfg.attn_logit_softcap,
                    window=window)[:, None].to(q.dtype)
            else:
                o = ops.chunked_prefill(
                    q.contiguous(), kp, vp, paged_tables, pos, lens,
                    scale=scale, cap=cfg.attn_logit_softcap,
                    window=window).to(q.dtype)
        return self.wo(o.reshape(b, t, cfg.n_heads * hd))


class MLA(torch.nn.Module):
    """Multi-head latent attention (``mla_init`` / ``mla_apply``). The
    projections ``wq``, ``w_dkv``, ``w_krope`` and ``wo`` are ``Linear``s;
    ``w_uk`` (kv_lora_rank, H·nope) and ``w_uv`` (kv_lora_rank, H·v) are bare
    parameters, as they are raw arrays in the JAX tree (used by einsum)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kl = cfg.kv_lora_rank
        kw = dict(device=device, dtype=dtype)
        self.wq = Linear(d, h * (dn + dr), **kw)
        self.w_dkv = Linear(d, kl, **kw)
        self.w_krope = Linear(d, dr, **kw)
        self.w_uk = torch.nn.Parameter(torch.zeros((kl, h * dn), **kw))
        self.w_uv = torch.nn.Parameter(torch.zeros((kl, h * dv), **kw))
        self.wo = Linear(h * dv, d, **kw)

    def forward(self, x, cos_sin, *, local: bool = False, cache=None,
                pos=None, paged_tables=None, lens=None,
                ctx: ParallelCtx = CPU_CTX):
        cfg = self.cfg
        b, t, _ = x.shape
        h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
        kl = cfg.kv_lora_rank
        scale = 1.0 / ((dn + dr) ** 0.5)
        q = self.wq(x).reshape(b, t, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        c = self.w_dkv(x)                                   # (b, t, kl)
        k_rope = self.w_krope(x)[:, :, None, :]             # (b, t, 1, dr)
        cos, sin = cos_sin
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope, cos, sin)[:, :, 0, :]
        w_uk = self.w_uk.to(x.dtype).reshape(kl, h, dn)
        w_uv = self.w_uv.to(x.dtype).reshape(kl, h, dv)
        if paged_tables is None:
            # expanded: per-head K/V from the latents, MHA over nope + rope
            k_nope = torch.einsum("btk,khd->bthd", c, w_uk)
            v = torch.einsum("btk,khd->bthd", c, w_uv)
            k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, dr)],
                          -1)
            v_p = torch.nn.functional.pad(v, (0, dn + dr - dv))
            o = sdpa(torch.cat([q_nope, q_rope], -1), k, v_p, ctx=ctx,
                     causal=True, scale=scale)[..., :dv]
        else:
            # absorbed, over latent pages: write row i's t latents at
            # positions pos[i] + j (padded tail tokens land in the row's last
            # partial page or the trash page, as GQA's K/V do), read the
            # row's pages through its padded table as one contiguous
            # envelope with this chunk's latents laid over their positions —
            # the JAX gather path's envelope, so a padded token whose page is
            # the trash page sees its own row's latents, never another row's
            # (its hidden state feeds the MoE's capacity selection) — and
            # attend in latent space under per-row causal masks
            cp, rp = cache["c"], cache["k_rope"]
            bs = cp.shape[1]
            tables = paged_tables.long()
            p = pos.long()[:, None] + torch.arange(t, device=x.device)
            blk = torch.gather(tables, 1, p // bs)
            c, k_rope = c.to(cp.dtype), k_rope.to(rp.dtype)
            cp.index_put_((blk, p % bs), c)
            rp.index_put_((blk, p % bs), k_rope)
            n_keys = tables.shape[1] * bs
            cf = cp[tables].reshape(b, n_keys, kl)
            rf = rp[tables].reshape(b, n_keys, dr)
            cf.scatter_(1, p[..., None].expand(b, t, kl), c)
            rf.scatter_(1, p[..., None].expand(b, t, dr), k_rope)
            cf, rf = cf.to(x.dtype), rf.to(x.dtype)
            q_c = torch.einsum("bthd,khd->bthk", q_nope, w_uk)
            s = (torch.einsum("bthk,bsk->bhts", q_c, cf)
                 + torch.einsum("bthd,bsd->bhts", q_rope, rf))
            s = s.float() * scale
            ok = p[:, :, None] >= torch.arange(n_keys, device=x.device)
            zero = torch.zeros((), dtype=s.dtype, device=s.device)
            s = s + torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None]
            pr = torch.softmax(s, dim=-1).to(x.dtype)
            ctx_c = torch.einsum("bhts,bsk->bthk", pr, cf)
            o = torch.einsum("bthk,khd->bthd", ctx_c, w_uv)
        return self.wo(o.reshape(b, t, h * dv))
