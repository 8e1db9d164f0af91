"""Causal flash attention: wrapper of ``csrc/flash_attention.cu`` (port of
``repro/kernels/flash_attention.py``).

softmax(cap·tanh(QKᵀ·scale/cap)) V over contiguous (B, T, H, hd) tensors,
causal, with GQA (query head h reads KV head h // (Hq/Hkv)). A CPU tensor
runs the plain version (``ref.flash_attention_ref``); a CUDA tensor launches
the CUDA kernel or raises. Like the Pallas kernel it has no backward, so the
wrapper refuses inputs that need a gradient (training runs the dense path).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank_linear import DTYPES
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)     # head sizes the kernel is compiled for

launches = 0          # calls that launched the CUDA kernel


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
    out = torch.empty_like(q)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, hq,
            hkv, hd, float(scale), float(cap), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
