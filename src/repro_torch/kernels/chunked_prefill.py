"""Chunked prefill: wrapper of ``csrc/chunked_prefill.cu`` and its plain
version (port of ``repro/kernels/chunked_prefill.py``).

Batched suffix prefill over the paged pool: row b's L queries sit at global
positions ``starts[b] + j`` and attend keys ``[0, starts[b] + j]`` through
the row's block table. A CPU tensor runs ``chunked_prefill_ref``; a CUDA
tensor launches the CUDA kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank_linear import DTYPES
from repro_torch.kernels.paged_attention import NEG_INF, check_paged_args

launches = 0          # calls that launched the CUDA kernel


def chunked_prefill(q, k_pages, v_pages, block_tables, starts, lens, *,
                    scale=None, cap: float = 0.0, window: int = 0):
    """Batched suffix-prefill attention over a paged KV cache.

    q: (B, L, Hq, hd) — each row's suffix queries, rotary already applied,
      right-padded to the shared length bucket ``L``.
    k_pages/v_pages: (num_blocks, bs, Hkv, hd) — already holding the suffix K/V.
    block_tables: (B, nb) int32; starts: (B,) int32 cached-prefix lengths;
    lens: (B,) int32 valid suffix tokens per row (padded queries past
      ``lens[b]`` and rows with ``lens[b] == 0`` return zeros).

    Returns (B, L, Hq, hd) in q.dtype.
    """
    if q.device.type == "cpu":
        return chunked_prefill_ref(q, k_pages, v_pages, block_tables, starts,
                                   lens, scale=scale, cap=cap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, starts, lens,
                   scale=scale, cap=cap, window=window)


def _launch(q, k_pages, v_pages, block_tables, starts, lens, *, scale, cap,
            window):
    global launches
    if q.ndim != 4:
        raise ValueError("chunked_prefill: q must be (B, L, Hq, hd)")
    check_paged_args("chunked_prefill", q, k_pages, v_pages, block_tables,
                     (("starts", starts), ("lens", lens)))
    b, lq, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.repro_chunked_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, lq, hq, hkv, hd, bs, nb, float(scale),
            float(cap), int(window), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "chunked_prefill")
    launches += 1
    return out


def chunked_prefill_ref(q, k_pages, v_pages, block_tables, starts, lens, *,
                        scale=None, cap: float = 0.0, window: int = 0):
    """Plain PyTorch version and test oracle: gathers only the pages named
    by the block tables and runs a masked softmax in fp32 with per-row
    prefix-offset causal masks."""
    b, lq, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, nb * bs, hkv, hd)
    v = v_pages[tables].reshape(b, nb * bs, hkv, hd)
    qg = q.reshape(b, lq, hkv, g, hd)
    s = torch.einsum("blkgd,bskd->bkgls", qg.float(), k.float()) * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    st, ln = starts.long(), lens.long()
    iq = st[:, None] + torch.arange(lq, device=q.device)        # (B, L)
    ik = torch.arange(nb * bs, device=q.device)
    ok = iq[..., None] < (st + ln)[:, None, None]               # padded queries
    ok = ok & (ik[None, None] <= iq[..., None])                 # offset causal
    if window > 0:
        ok = ok & ((iq[..., None] - ik[None, None]) < window)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))          # all-masked -> 0
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgls,bskd->blkgd", p / torch.clamp(l, min=1e-30),
                     v.float())
    return o.reshape(b, lq, hq, hd).to(q.dtype)
