"""Causal flash attention: wrapper of ``csrc/flash_attention.cu`` (port of
``repro/kernels/flash_attention.py``).

softmax(cap·tanh(QKᵀ·scale/cap)) V over contiguous (B, T, H, hd) tensors,
causal, with GQA (query head h reads KV head h // (Hq/Hkv)). A CPU tensor
runs the plain version (``ref.flash_attention_ref``); a CUDA tensor launches
the CUDA kernel or raises. Like the Pallas kernel it has no backward, so the
wrapper refuses inputs that need a gradient (training runs the dense path).

A kernel block owns ``plan().rows`` flat query rows r = j·G + g of one
(batch, KV head) and walks the key tiles of ``KEYS`` keys up to its last
row's diagonal (``live_keys``). The plan lives here, in Python, and
``flash_attention_tiled_ref`` is the plain version of that tiling and its
online softmax, so the CPU tests reach both.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank_linear import DTYPES
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

HEAD_DIMS = (16, 32, 48, 64, 128, 192)   # head sizes the kernel is compiled
                      # for; 48 and 192 are MLA's nope + rope (SMOKE, full)
WIDE_HEAD_DIMS = (16, 32, 64)     # the head sizes with ROWS-row tiles
KEYS = 64                         # keys per K/V tile
ROWS = 128            # query rows per block: fp32 8 x 8 register blocks of 128
                      # threads, bf16 four warps of two m16 tiles
THIN_ROWS = 64        # fp32 8 x 4 blocks, bf16 one m16 tile per warp: twice the
                      # blocks, for thin grids; the only tile at hd 128 and 192
                      # (registers) and at hd 48 (the fp32 lanes' dim split)
FILL_BLOCKS = 264     # two blocks on each of the H100's 132 SMs

launches = 0          # calls that launched the CUDA kernel


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """Row tiles of ``rows`` flat rows r = j·G + g per (batch, KV head);
    ``blocks`` = B · Hkv · row_tiles, the kernel's one-dimensional grid."""
    rows: int
    row_tiles: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan(b: int, t: int, hq: int, hkv: int, hd: int, dtype: torch.dtype) -> FlashPlan:
    """``ROWS`` rows per block at the ``WIDE_HEAD_DIMS``, unless that grid
    would leave the card under ``FILL_BLOCKS`` blocks (the compress path's
    B 8, T 64 makes 128): then ``THIN_ROWS``, as at every other head size."""
    if dtype not in DTYPES or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no tile for {dtype} at head_dim {hd}")
    rows_g = t * (hq // hkv)
    rows = ROWS
    if hd not in WIDE_HEAD_DIMS or b * hkv * -(-rows_g // ROWS) < FILL_BLOCKS:
        rows = THIN_ROWS
    row_tiles = -(-rows_g // rows)
    return FlashPlan(rows, row_tiles, b * hkv * row_tiles)


def block_tile(p: FlashPlan, x: int, hkv: int):
    """(row tile, batch, KV head) of block ``x`` (the kernel's
    ``block_tile``): the last row tile, with the longest diagonal, first."""
    nbh = p.blocks // p.row_tiles
    bh = x % nbh
    return p.row_tiles - 1 - x // nbh, bh // hkv, bh % hkv


def live_keys(rt: int, t: int, g: int, rows: int):
    """(key tiles, kc) of row tile ``rt``: tiles 0 .. key_tiles-1 reach its
    last real row's diagonal, and the last of them is computed up to its
    first ``kc`` keys only."""
    j1 = min(t - 1, (rt * rows + rows - 1) // g)
    n_kt = j1 // KEYS + 1
    return n_kt, j1 - (n_kt - 1) * KEYS + 1


def flash_attention(q, k, v, *, scale=None, cap: float = 0.0):
    """q: (B, T, Hq, hd); k/v: (B, T, Hkv, hd); causal. Returns (B, T, Hq, hd)
    in q.dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() "
            "or use ParallelCtx(use_pallas=False) for training")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, scale=scale, cap=cap)


def _launch(q, k, v, *, scale, cap):
    global launches
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, T, Hq, hd) and k, v "
                         "(B, T, Hkv, hd)")
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype}, q is {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if t == 0 or b == 0:
        raise ValueError("flash_attention: empty input")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    p = plan(b, t, hq, hkv, hd, q.dtype)
    out = torch.empty_like(q)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, hq,
            hkv, hd, p.rows, float(scale), float(cap), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out


def flash_attention_tiled_ref(q, k, v, *, scale=None, cap: float = 0.0):
    """Plain version of the kernel's tiling, for the tests: per (batch, KV
    head), the flat rows r = j·G + g in the plan's row tiles, each walking
    its key tiles (``live_keys``) with the online softmax — scores in log2
    units, (m, l, acc) in fp32, p = exp2(y − m), l summing the unrounded p;
    for bf16 inputs P is rounded to bf16 before P·V, as the kernel (and the
    Pallas kernel's ``p.astype(v.dtype)``) does."""
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    p = plan(b, t, hq, hkv, hd, q.dtype)
    n_rows = t * g
    qr = q.reshape(b, t, hkv, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, n_rows, hd).float()
    kf = k.permute(0, 2, 1, 3).float()                           # (B, Hkv, T, hd)
    vf = v.permute(0, 2, 1, 3).float()
    j = torch.arange(n_rows, device=q.device) // g
    out = torch.empty_like(qr)
    for rt in range(p.row_tiles):
        r0, r1 = rt * p.rows, min(n_rows, (rt + 1) * p.rows)
        n_kt, _ = live_keys(rt, t, g, p.rows)
        m = torch.full((b, hkv, r1 - r0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, r1 - r0, hd), device=q.device)
        for kt in range(n_kt):
            k0, k1 = kt * KEYS, min(t, (kt + 1) * KEYS)
            x = torch.einsum("bhrd,bhkd->bhrk", qr[:, :, r0:r1], kf[:, :, k0:k1]) * scale
            if cap > 0:
                x = cap * torch.tanh(x / cap)
            y = x * math.log2(math.e)
            ik = torch.arange(k0, k1, device=q.device)
            y = torch.where(ik[None, :] <= j[r0:r1, None], y, torch.full_like(y, NEG_INF))
            mn = torch.maximum(m, y.amax(-1))
            corr = torch.exp2(m - mn)
            pr = torch.exp2(y - mn[..., None])
            l = l * corr + pr.sum(-1)
            if q.dtype == torch.bfloat16:
                pr = pr.to(torch.bfloat16).float()
            acc = acc * corr[..., None] + torch.einsum("bhrk,bhkd->bhrd", pr,
                                                       vf[:, :, k0:k1])
            m = mn
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-30)[..., None]
    o = out.reshape(b, hkv, t, g, hd).permute(0, 2, 1, 3, 4)
    return o.reshape(b, t, hq, hd).to(q.dtype)
