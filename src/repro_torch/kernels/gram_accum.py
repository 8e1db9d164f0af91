"""Gram accumulation G = aᵀa: wrapper of ``csrc/gram_accum.cu`` (port of
``repro/kernels/gram_accum.py``).

One token chunk a (k_tokens, n), fp32 or bf16, gives its (n, n) fp32 Gram
contribution; ``core/calibrate.py`` sums the contributions of successive
records. A CPU tensor runs the plain version (``ref.gram_accum_ref``); a
CUDA tensor launches the CUDA kernel or raises.

The kernel computes the upper triangle of square tiles, one block each,
and mirrors it. The tile edge is planned here, in Python (``plan``), so
that the CPU tests reach it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank_linear import DTYPES
from repro_torch.kernels.ref import gram_accum_ref

launches = 0          # calls that launched the CUDA kernel

TILE, SMALL_TILE = 128, 64    # tile edges of csrc/gram_accum.cu
SMS = 132                     # the H100's SMs
SMALL_PER_SM = 4              # 64-tile blocks resident on an SM (64 threads)


def tiles(n: int, tile: int) -> int:
    """Upper-triangle tiles of edge ``tile`` over an (n, n) Gram."""
    nt = -(-n // tile)
    return nt * (nt + 1) // 2


def plan(n: int) -> int:
    """The tile edge: 64 when its tiles fit the card's resident 64-tile
    slots in one round (528 tiles at n = 2048, where the 136 tiles of 128
    would leave half the card idle), else 128 (2080 tiles at n = 8192,
    where the 64-tile needs as many rounds of FMAs and more loads)."""
    return SMALL_TILE if tiles(n, SMALL_TILE) <= SMS * SMALL_PER_SM else TILE


def gram_accum(a):
    """a: (k_tokens, n) chunk of Xᵀ -> (n, n) fp32 Gram contribution aᵀa."""
    if a.device.type == "cpu":
        return gram_accum_ref([a])
    if a.device.type != "cuda":
        raise ValueError(f"gram_accum: unsupported device {a.device}")
    return _launch(a)


def _launch(a):
    global launches
    if a.ndim != 2 or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"gram_accum: a must be a non-empty (k, n) matrix, "
                         f"got {tuple(a.shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"gram_accum: unsupported dtype {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("gram_accum: a must be contiguous")
    k, n = a.shape
    g = torch.empty((n, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.lib().repro_gram_accum(
            a.data_ptr(), g.data_ptr(), k, n, plan(n), DTYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "gram_accum")
    launches += 1
    return g
