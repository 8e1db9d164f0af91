"""Chunked prefill: wrapper of ``csrc/chunked_prefill.cu`` and its plain
versions (port of ``repro/kernels/chunked_prefill.py``).

Batched suffix prefill over the paged pool: row b's L queries sit at global
positions ``starts[b] + j`` and attend keys ``[0, starts[b] + j]`` through
the row's block table. A CPU tensor runs ``chunked_prefill_ref``; a CUDA
tensor launches the CUDA kernel or raises.

The kernel splits each row tile's keys across blocks (flash-decoding) and
combines the blocks' (m, l, acc) partials. The split plan lives here, in
Python (``plan``, ``live_key_tiles``), and ``chunked_prefill_split_ref``
is the plain version of the split and the combine, so the CPU tests reach
both.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank_linear import DTYPES
from repro_torch.kernels.paged_attention import NEG_INF, check_paged_args

launches = 0          # calls that launched the CUDA kernel

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's compiled head sizes
ROWS = 64             # query rows (query, head) per block
KEYS = 64             # keys per key tile
TARGET_BLOCKS = 528   # four blocks per SM of the H100's 132: about half of a
                      # causal prefill's (row tile, split) blocks are dead


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Row tiles of ``ROWS`` query rows per (row, KV head); the
    ``key_tiles`` tiles of ``KEYS`` keys cut into ``splits`` ranges of
    ``per`` tiles (the last may be shorter, none is empty)."""
    row_tiles: int
    key_tiles: int
    splits: int
    per: int
    workspace: int        # fp32 elements of (m, l, acc) partials; 0 unsplit

    def key_tile_ranges(self):
        return [(s * self.per, min(self.key_tiles, (s + 1) * self.per))
                for s in range(self.splits)]


def plan(b: int, lq: int, hq: int, hkv: int, hd: int, bs: int, nb: int) -> SplitPlan:
    """Split the key tiles until about ``TARGET_BLOCKS`` (row tile, split)
    blocks exist: at B = 1 a 256-token prefill has 8 heads x 16 row tiles,
    under one block per SM, and its diagonal tiles hold the most keys."""
    row_tiles = -(-lq * (hq // hkv) // ROWS)
    key_tiles = -(-nb * bs // KEYS)
    base = b * hkv * row_tiles
    splits = max(1, min(key_tiles, -(-TARGET_BLOCKS // base)))
    per = -(-key_tiles // splits)
    splits = -(-key_tiles // per)
    ws = splits * b * hkv * row_tiles * ROWS * (hd + 2) if splits > 1 else 0
    return SplitPlan(row_tiles, key_tiles, splits, per, ws)


def live_key_tiles(rt, starts, lens, lq: int, g: int, window: int, n_keys: int):
    """Key tiles [lo, hi] that row tile ``rt`` of each row can attend (the
    kernel's ``live_key_tiles``): lo > hi where the tile holds no valid
    query or no key is in reach. starts/lens: (B,) int tensors."""
    j0 = rt * ROWS // g
    j1 = torch.minimum(torch.clamp(lens, max=lq) - 1,
                       torch.full_like(lens, (rt * ROWS + ROWS - 1) // g))
    kmax = torch.clamp(starts + j1, max=n_keys - 1)
    if window > 0:
        kmin = torch.clamp(starts + j0 - window + 1, min=0)
    else:
        kmin = torch.zeros_like(starts)
    dead = (j1 < j0) | (kmax < kmin)
    lo = torch.where(dead, torch.ones_like(kmin), kmin // KEYS)
    hi = torch.where(dead, torch.zeros_like(kmax), kmax // KEYS)
    return lo, hi


def chunked_prefill(q, k_pages, v_pages, block_tables, starts, lens, *,
                    scale=None, cap: float = 0.0, window: int = 0):
    """Batched suffix-prefill attention over a paged KV cache.

    q: (B, L, Hq, hd) — each row's suffix queries, rotary already applied,
      right-padded to the shared length bucket ``L``.
    k_pages/v_pages: (num_blocks, bs, Hkv, hd) — already holding the suffix
      K/V, in the cache dtype (fp32 or bf16, q's or not).
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"chunked_prefill: head size {hd} not in {HEAD_DIMS}")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    p = plan(b, lq, hq, hkv, hd, bs, nb)
    out = torch.empty_like(q)
    work = (torch.empty(p.workspace, dtype=torch.float32, device=q.device)
            if p.workspace else None)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.repro_chunked_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            out.data_ptr(), 0 if work is None else work.data_ptr(), b, lq, hq,
            hkv, hd, bs, nb, float(scale), float(cap), int(window), p.splits,
            p.per, DTYPES[q.dtype], DTYPES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "chunked_prefill")
    launches += 1
    return out


def chunked_prefill_ref(q, k_pages, v_pages, block_tables, starts, lens, *,
                        scale=None, cap: float = 0.0, window: int = 0):
    """Plain PyTorch version and test oracle: gathers only the pages named
    by the block tables and runs a masked softmax in fp32 with per-row
    prefix-offset causal masks; the probabilities are rounded to the pages'
    dtype before P·V, as the Pallas kernel does (a no-op for fp32 pages)."""
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
    p = p.to(v_pages.dtype).float()
    o = torch.einsum("bkgls,bskd->blkgd", p / torch.clamp(l, min=1e-30),
                     v.float())
    return o.reshape(b, lq, hq, hd).to(q.dtype)


def chunked_prefill_split_ref(q, k_pages, v_pages, block_tables, starts, lens, *,
                              scale=None, cap: float = 0.0, window: int = 0):
    """Plain version of the kernel's split and combine: query rows r = j*G + g
    of each (row, KV head) in tiles of ``ROWS``, keys in tiles of ``KEYS``
    cut into the plan's ranges. Each split computes
    (m, l, acc) over its keys with the masks, the NEG_INF/2 shift and the P
    rounding of ``chunked_prefill_ref``; the combine takes, per row tile, exactly the
    splits its live key range reaches, in split order."""
    b, lq, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    p = plan(b, lq, hq, hkv, hd, bs, nb)
    n_keys, rows, keys, per = nb * bs, ROWS, KEYS, p.per
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, n_keys, hkv, hd).float()
    v = v_pages[tables].reshape(b, n_keys, hkv, hd).float()
    n_rows = lq * g
    qr = q.reshape(b, lq, hkv, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, n_rows, hd).float()
    s = torch.einsum("bhrd,bkhd->bhrk", qr, k) * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    st, ln = starts.long(), lens.long()
    j = torch.arange(n_rows, device=q.device) // g
    iq = st[:, None] + j                                        # (B, R)
    ik = torch.arange(n_keys, device=q.device)
    ok = (j[None] < ln[:, None])[..., None] & (ik <= iq[..., None])
    if window > 0:
        ok = ok & ((iq[..., None] - ik) < window)
    s = torch.where(ok[:, None], s, torch.full_like(s, NEG_INF))
    # live key-tile range of each row's tile: (B, R)
    lo = torch.empty((b, n_rows), dtype=torch.long, device=q.device)
    hi = torch.empty_like(lo)
    for rt in range(p.row_tiles):
        sl = slice(rt * rows, min(n_rows, (rt + 1) * rows))
        tlo, thi = live_key_tiles(rt, st, ln, lq, g, window, n_keys)
        lo[:, sl], hi[:, sl] = tlo[:, None], thi[:, None]
    parts = []
    for sp in range(p.splits):
        a, e = sp * per * keys, min(n_keys, (sp + 1) * per * keys)
        ss = s[..., a:e]
        m = torch.amax(ss, dim=-1)                              # (B, Hkv, R)
        pr = torch.exp(ss - torch.clamp(m, min=NEG_INF / 2)[..., None])
        live = (sp * per <= hi) & (lo <= (sp + 1) * per - 1)     # (B, R)
        pv = torch.einsum("bhrk,bkhd->bhrd", pr.to(v_pages.dtype).float(), v[:, a:e])
        parts.append((m, pr.sum(-1), pv, live[:, None]))
    mx = torch.full_like(parts[0][0], NEG_INF)
    for m, _, _, live in parts:
        mx = torch.where(live, torch.maximum(mx, m), mx)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(qr)
    for m, ls, ac, live in parts:
        w = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
        l = l + w * ls
        acc = acc + w[..., None] * ac
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    o = o.reshape(b, hkv, lq, g, hd).permute(0, 2, 1, 3, 4)
    return o.reshape(b, lq, hq, hd).to(q.dtype)
