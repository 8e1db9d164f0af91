"""Paged-attention decode: wrapper of ``csrc/paged_attention.cu`` and its
plain version (port of ``repro/kernels/paged_attention.py``).

One decode step attends a single query token per request against that
request's KV history, scattered over fixed-size pages of the shared pool
and addressed through a per-request block table. A CPU tensor runs
``paged_attention_ref``; a CUDA tensor launches the CUDA kernel or raises.

The kernel splits each row's pages across blocks (flash-decoding) and
combines the blocks' (m, l, acc) partials. The split plan lives here, in
Python (``plan``), and ``paged_attention_split_ref`` is the plain version of
the split and the combine, so the CPU tests reach both.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank_linear import DTYPES, call_scratch

NEG_INF = -1e30

launches = 0          # calls that launched the CUDA kernel

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's compiled head sizes
MAX_G = 8             # query heads per KV head the kernel takes
TARGET_BLOCKS = 396   # resident at once: three blocks per SM of the H100's
                      # 132 (~68 KB of shared memory each at hd 64 fp32)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """The table's ``nb`` pages cut into ``splits`` ranges of ``per`` pages
    (the last may be shorter, none is empty); block (row, KV head, split)."""
    nb: int
    splits: int
    per: int
    workspace: int        # fp32 elements of (m, l, acc) partials; 0 unsplit

    def page_ranges(self):
        return [(s * self.per, min(self.nb, (s + 1) * self.per))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=1024)
def plan(b: int, hq: int, hkv: int, hd: int, nb: int) -> PagedPlan:
    """Split the pages into as many ranges as keep the (row, KV head, split)
    blocks within ``TARGET_BLOCKS``, so that they run in one round: at the
    serve path's decode, B 8 x Hkv 8 = 64 unsplit blocks would leave half of
    the 132 SMs idle."""
    splits = max(1, min(nb, TARGET_BLOCKS // (b * hkv)))
    per = -(-nb // splits)
    splits = -(-nb // per)
    ws = splits * b * hq * (hd + 2) if splits > 1 else 0
    return PagedPlan(nb, splits, per, ws)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None, cap: float = 0.0, window: int = 0):
    """Decode-step attention over a paged KV cache.

    q: (B, Hq, hd) — one query token per request, already rotary-embedded.
    k_pages/v_pages: (num_blocks, bs, Hkv, hd) — the shared block pool, in
      the cache dtype (fp32 or bf16, q's or not).
    block_tables: (B, nb) int32 — page ids per request, padded with page 0.
    lengths: (B,) int32 — valid positions per request (query at length-1);
      0 marks a padding row and yields a zero output row.

    Returns (B, Hq, hd) in q.dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   scale=scale, cap=cap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, lengths, scale=scale,
                   cap=cap, window=window)


def check_paged_args(name, q, k_pages, v_pages, block_tables, int_args):
    """Validate the arguments shared by the two paged attention kernels: q
    in the compute dtype and the pages in the cache dtype, each fp32 or
    bf16, the two page stores in one dtype."""
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pages must be (num_blocks, bs, Hkv, hd)")
    hkv, hd = k_pages.shape[2], k_pages.shape[3]
    if q.shape[-1] != hd or q.shape[-2] % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    for arg, t in (("q", q), ("k_pages", k_pages)):
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: unsupported {arg} dtype {t.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: v_pages is {v_pages.dtype}, k_pages is "
                         f"{k_pages.dtype}")
    b = q.shape[0]
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be (B, nb)")
    for arg, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                   ("block_tables", block_tables), *int_args):
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in (("block_tables", block_tables), *int_args):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")
    for arg, t in int_args:
        if t.shape != (b,):
            raise ValueError(f"{name}: {arg} must be ({b},)")


def _launch(q, k_pages, v_pages, block_tables, lengths, *, scale, cap, window):
    global launches
    if q.ndim != 3:
        raise ValueError("paged_attention: q must be (B, Hq, hd)")
    check_paged_args("paged_attention", q, k_pages, v_pages, block_tables,
                     (("lengths", lengths),))
    b, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head size {hd} not in {HEAD_DIMS}")
    if hq // hkv > MAX_G:
        raise ValueError(f"paged_attention: {hq // hkv} query heads per KV head, "
                         f"the kernel takes at most {MAX_G}")
    if nb == 0:
        raise ValueError("paged_attention: empty block tables")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    p = plan(b, hq, hkv, hd, nb)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work = (call_scratch(q.device, stream, p.workspace, 0)[0]
            if p.workspace else None)
    with torch.cuda.device(q.device):
        err = _build.lib().repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(), b, hq, hkv, hd, bs, nb,
            float(scale), float(cap), int(window), p.splits, p.per,
            DTYPES[q.dtype], DTYPES[k_pages.dtype], stream)
    _build.check(err, "paged_attention")
    launches += 1
    return out


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None, cap: float = 0.0, window: int = 0):
    """Plain PyTorch version and test oracle: gathers only the pages named
    by the block tables and runs a masked softmax in fp32; the probabilities
    are rounded to the pages' dtype before P·V, as the Pallas kernel does
    (``p.astype(v.dtype)``; a no-op for fp32 pages)."""
    b, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, nb * bs, hkv, hd)
    v = v_pages[tables].reshape(b, nb * bs, hkv, hd)
    qg = q.reshape(b, hkv, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    ik = torch.arange(nb * bs, device=q.device)
    lens = lengths.long()
    ok = ik[None] < lens[:, None]
    if window > 0:
        ok &= (lens[:, None] - 1 - ik[None]) < window
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))   # all-masked rows -> 0
    l = torch.sum(p, dim=-1, keepdim=True)
    p = p.to(v_pages.dtype).float()
    o = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp(l, min=1e-30), v.float())
    return o.reshape(b, hq, hd).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              scale=None, cap: float = 0.0, window: int = 0):
    """Plain version of the kernel's split and combine: the plan's page
    ranges each give (m, l, acc) over their keys with the masks, the
    NEG_INF/2 shift and the P rounding of ``paged_attention_ref``; the
    combine takes, per row,
    exactly the splits holding an attended key, in split order, and a row
    with none gives zeros."""
    b, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    p = plan(b, hq, hkv, hd, nb)
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, nb * bs, hkv, hd).float()
    v = v_pages[tables].reshape(b, nb * bs, hkv, hd).float()
    qg = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    ik = torch.arange(nb * bs, device=q.device)
    lens = lengths.long()
    ok = ik[None] < lens[:, None]
    if window > 0:
        ok &= (lens[:, None] - 1 - ik[None]) < window
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    # attended keys [klo, khi) of each row
    khi = torch.clamp(lens, min=0, max=nb * bs)
    klo = torch.clamp(lens - window, min=0) if window > 0 else torch.zeros_like(lens)
    parts = []
    for lo, hi in p.page_ranges():
        a, e = lo * bs, hi * bs
        ss = s[..., a:e]
        m = torch.amax(ss, dim=-1)                              # (B, Hkv, G)
        pr = torch.exp(ss - torch.clamp(m, min=NEG_INF / 2)[..., None])
        live = torch.clamp(klo, min=a) < torch.clamp(khi, max=e)   # (B,)
        pv = torch.einsum("bkgs,bskd->bkgd", pr.to(v_pages.dtype).float(), v[:, a:e])
        parts.append((m, pr.sum(-1), pv, live[:, None, None]))
    mx = torch.full_like(parts[0][0], NEG_INF)
    for m, _, _, live in parts:
        mx = torch.where(live, torch.maximum(mx, m), mx)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(qg)
    for m, ls, ac, live in parts:
        w = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
        l = l + w * ls
        acc = acc + w[..., None] * ac
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, hd).to(q.dtype)
