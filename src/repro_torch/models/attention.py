"""GQA attention (port of ``repro/models/attention.py:196-294``, GQA only).

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
