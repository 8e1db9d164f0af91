"""Low-rank linear y = (x @ b_t) @ a_t: wrapper of ``csrc/lowrank_linear.cu``.

Port of ``repro/kernels/lowrank_linear.py``. A CPU tensor runs the plain
version (``ref.lowrank_linear_ref``, which autograd differentiates); a CUDA
tensor launches the CUDA kernel (two GEMMs, the intermediate cast to x's
dtype in between) or raises.

Under autograd a CUDA call goes through ``LowRankLinear``, an
``autograd.Function`` (adapter fine-tuning trains ``b_t``/``a_t``). With
t = x·b_t (cast to x's dtype) and u = dy·a_tᵀ (cast likewise):

    dx = u·b_tᵀ = (dy·a_tᵀ)·b_tᵀ      — itself a low-rank product: one more
                                        launch of the kernel, on a_tᵀ, b_tᵀ
    da_t = tᵀ·dy,  db_t = xᵀ·u        — plain products, as the JAX package's
                                        autodiff forms them outside Pallas

The forward keeps t, copied out of the call's scratch (M·r elements, the
value the kernel really used; recomputing it would cost an M·d_in·r
product), and the dx launch hands back its own intermediate u for db_t, so
the backward computes no product twice. Where x needs no gradient, u comes
from one plain product and the kernel is not launched.

The launch plan lives here, in Python, so that the CPU tests reach it: which
kernel each of the two products takes (``decode`` for M <= 16 rows, a
``prefill`` tile above), how K is split across blocks and how much fp32
workspace the split needs. The CUDA source checks that a plan it is given
fits its tiles and refuses one that does not.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lowrank_linear_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # calls that launched the CUDA kernel
backward_launches = 0  # of those, the launches made by a backward (dx)

SMALL_M = 16          # rows up to which a product takes the decode kernel
_BIG = 1 << 30
# Per kernel, as in csrc/lowrank_linear.cu: (BM, BN, BK, least k per split,
# most k per split, splits aimed under, blocks wanted); BM is also the tile
# code the CUDA side is given. The fp32 decode kernel keeps x's K slice in
# shared memory (hence its hard cap of 512 k). The split-K sum of a tile is
# read by one block, so the planner keeps splits x tile <= 256 KB of
# partials (512 KB at decode) where it can; the split count is not a limit
# of the kernels (``plan_ok`` in the CUDA source checks only that the splits
# cover K), and a K past splits x k_max takes more splits: gemma2's down
# projection (K 36864) takes 72 splits of 512 k at fp32 decode, 590 KB of
# partials per 16 x 128 tile. The fp32 prefill tile is 64 x 64 (two warps),
# eight blocks to an SM.
TILES = {
    ("decode", torch.float32): (16, 128, 16, 48, 512, 64, 264),
    ("prefill", torch.float32): (64, 64, 8, 64, _BIG, 8, 528),
    ("decode", torch.bfloat16): (16, 128, 32, 64, _BIG, 64, 264),
    ("prefill", torch.bfloat16): (128, 128, 32, 128, _BIG, 4, 264),
}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One product C (m, n) = A (m, k) @ B (k, n): block (x, y, z) computes
    output tile (y, x) over k in [z * kchunk, min(k, (z + 1) * kchunk))."""
    m: int
    n: int
    k: int
    kind: str             # "decode" or "prefill"
    tile: int             # the kernel's code for the C side: its BM
    tiles_m: int
    tiles_n: int
    splits: int
    kchunk: int

    @property
    def workspace(self) -> int:
        """fp32 elements of split-K partials (0 when K is not split)."""
        return self.splits * self.m * self.n if self.splits > 1 else 0

    @property
    def counters(self) -> int:
        """int32 arrival counters, one per output tile (0 when unsplit)."""
        return self.tiles_m * self.tiles_n if self.splits > 1 else 0

    def k_ranges(self):
        return [(z * self.kchunk, min(self.k, (z + 1) * self.kchunk))
                for z in range(self.splits)]


def gemm_plan(m: int, n: int, k: int, dtype=torch.float32) -> GemmPlan:
    """Split K across blocks until the kernel's wanted block count is in
    flight, within its bounds on k per split and on splits; every split is
    non-empty."""
    kind = "decode" if m <= SMALL_M else "prefill"
    bm, bn, bk, k_min, k_max, s_max, blocks = TILES[(kind, dtype)]
    tiles_m, tiles_n = _cdiv(m, bm), _cdiv(n, bn)
    splits = min(_cdiv(blocks, tiles_m * tiles_n), k // k_min, s_max)
    splits = max(1, splits, _cdiv(k, k_max))
    kchunk = _cdiv(_cdiv(k, splits), bk) * bk
    return GemmPlan(m, n, k, kind, bm, tiles_m, tiles_n, _cdiv(k, kchunk), kchunk)


@functools.lru_cache(maxsize=1024)
def plan(m: int, d_in: int, r: int, d_out: int,
         dtype=torch.float32) -> Tuple[GemmPlan, GemmPlan]:
    """The two products of one call: t = x @ b_t, then y = t @ a_t."""
    return gemm_plan(m, r, d_in, dtype), gemm_plan(m, d_out, r, dtype)


# Scratch kept per (device, stream), shared by the kernels that need it
# (this one and paged_attention's splits): one fp32 buffer (here the split-K
# partials and, after them at a 16-byte boundary, the intermediate t in x's
# dtype) and int32 arrival counters. A kernel uses them only until its
# call's launches end, so calls on one stream reuse them in stream order.
# The last block of a split tile resets its counter to 0, so the counters
# are zeroed once, when the buffer is made.
#
# A CUDA graph bakes the buffer's address into its kernels, so a stream that
# graphs are captured on reserves its scratch before the first capture
# (``reserve_scratch``, sized for the largest signature) and the buffer is
# never replaced after that: replacing it would free memory the captured
# kernels still write into.
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_pinned: set = set()      # keys whose buffer captured graphs hold


def scratch_layout(m: int, d_in: int, r: int, d_out: int,
                   dtype=torch.float32) -> Tuple[int, int, int]:
    """Scratch of one call: (fp32 elements of split-K partials, rounded to
    16 bytes; fp32 elements holding the intermediate t; int32 counters)."""
    p1, p2 = plan(m, d_in, r, d_out, dtype)
    work_n = _cdiv(max(p1.workspace, p2.workspace), 4) * 4
    return work_n, _cdiv(m * r * dtype.itemsize, 4), max(p1.counters, p2.counters)


def _make_scratch(device, work: int, counters: int):
    return (torch.empty(max(work, 1), dtype=torch.float32, device=device),
            torch.zeros(max(counters, 1), dtype=torch.int32, device=device))


def call_scratch(device, stream: int, work: int, counters: int):
    """(fp32 buffer of at least ``work`` elements, zeroed int32 counters of
    at least ``counters``) for launches on ``stream`` of ``device``. Raises
    rather than replace a reserved buffer or allocate during a capture."""
    key = (device, stream)
    buf = _scratch.get(key)
    if buf is None or buf[0].numel() < work or buf[1].numel() < counters:
        if key in _pinned or (device.type == "cuda"
                              and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"scratch of stream {stream} needs {work} + {counters} "
                "elements beyond its reservation; reserve_scratch for the "
                "largest signature before the first capture")
        old_w, old_c = buf if buf is not None else (None, None)
        buf = _make_scratch(
            device, max(work, 0 if old_w is None else old_w.numel()),
            max(counters, 0 if old_c is None else old_c.numel()))
        _scratch[key] = buf
    return buf


def reserve_scratch(device, stream: int, work: int, counters: int):
    """Make the scratch of ``stream`` at least this large, once, before any
    graph is captured on it, and pin it: no later call may replace it."""
    key = (device, stream)
    if key in _pinned:
        buf = _scratch[key]
        if buf[0].numel() < work or buf[1].numel() < counters:
            raise RuntimeError(f"scratch of stream {stream} is already "
                               "reserved and held by captured graphs")
        return buf
    old = _scratch.get(key)
    if old is None or old[0].numel() < work or old[1].numel() < counters:
        _scratch[key] = _make_scratch(
            device, max(work, 0 if old is None else old[0].numel()),
            max(counters, 0 if old is None else old[1].numel()))
    _pinned.add(key)
    return _scratch[key]


def release_scratch(device, stream: int) -> None:
    """Drop the scratch of ``stream`` once no graph captured on it remains."""
    _pinned.discard((device, stream))
    _scratch.pop((device, stream), None)


def lowrank_linear(x, b_t, a_t):
    """x: (..., d_in); b_t: (d_in, r); a_t: (r, d_out) -> (..., d_out)."""
    if x.device.type == "cpu":
        return lowrank_linear_ref(x, b_t, a_t)
    if x.device.type != "cuda":
        raise ValueError(f"lowrank_linear: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, b_t, a_t)):
        return LowRankLinear.apply(x, b_t, a_t)
    return _launch(x, b_t, a_t)[0]


class LowRankLinear(torch.autograd.Function):
    """The CUDA kernel under autograd; the backward's dx is one more launch."""

    @staticmethod
    def forward(ctx, x, b_t, a_t):
        y, t = _launch(x, b_t, a_t, keep_t=ctx.needs_input_grad[2])
        ctx.save_for_backward(x, b_t, a_t, t)
        return y

    @staticmethod
    def backward(ctx, dy):
        global backward_launches
        x, b_t, a_t, t = ctx.saved_tensors
        need_x, need_b, need_a = ctx.needs_input_grad
        dy = dy.contiguous()
        dym = dy.reshape(-1, dy.shape[-1])
        dx = db_t = da_t = None
        u = None
        if need_x:
            dx, u = _launch(dy, a_t.T.contiguous(), b_t.T.contiguous(),
                            keep_t=need_b)
            backward_launches += 1
        if need_b:
            if u is None:
                u = dym @ a_t.T
            db_t = x.reshape(-1, b_t.shape[0]).T @ u
        if need_a:
            da_t = t.T @ dym
        return dx, db_t, da_t


def _launch(x, b_t, a_t, *, keep_t: bool = False):
    """Launch the kernel; returns (y, a copy of the intermediate t = x·b_t
    in x's dtype, (M, r), when ``keep_t``, else None)."""
    global launches
    if b_t.ndim != 2 or a_t.ndim != 2:
        raise ValueError("lowrank_linear: b_t and a_t must be 2-D")
    d_in, r = b_t.shape
    r2, d_out = a_t.shape
    if x.shape[-1] != d_in or r2 != r:
        raise ValueError(f"lowrank_linear: shapes {tuple(x.shape)} @ "
                         f"{tuple(b_t.shape)} @ {tuple(a_t.shape)} do not chain")
    for name, t in (("x", x), ("b_t", b_t), ("a_t", a_t)):
        if t.device != x.device:
            raise ValueError(f"lowrank_linear: {name} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"lowrank_linear: {name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lowrank_linear: {name} must be contiguous")
    if x.dtype not in DTYPES:
        raise ValueError(f"lowrank_linear: unsupported dtype {x.dtype}")
    xm = x.reshape(-1, d_in)
    m = xm.shape[0]
    if m == 0:
        raise ValueError("lowrank_linear: empty input")
    p1, p2 = plan(m, d_in, r, d_out, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work_n, t_n, n_counters = scratch_layout(m, d_in, r, d_out, x.dtype)
    work, counters = call_scratch(x.device, stream, work_n + t_n, n_counters)
    t = work[work_n:work_n + t_n].view(x.dtype)
    y = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().repro_lowrank_linear(
            xm.data_ptr(), b_t.data_ptr(), a_t.data_ptr(), y.data_ptr(),
            t.data_ptr(), work.data_ptr(), counters.data_ptr(), m, d_in, r, d_out,
            p1.splits, p1.kchunk, p1.tile, p2.splits, p2.kchunk, p2.tile,
            DTYPES[x.dtype], stream)
    _build.check(err, "lowrank_linear")
    launches += 1
    kept = t[:m * r].view(m, r).clone() if keep_t else None   # t_n rounds up
    return y.view(*x.shape[:-1], d_out), kept
