"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

The paged-attention and chunked-prefill plain versions live beside their
kernels, as in the JAX package."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def lowrank_linear_ref(x, b_t, a_t):
    """y = (x @ b_t) @ a_t — COALA factored linear. x: (..., d_in)."""
    return (x @ b_t) @ a_t


def gram_accum_ref(chunks):
    """G = Σ_c cᵀ c over token chunks (rows of Xᵀ), in fp32. chunks: an
    iterable of (k, n) tensors."""
    g = None
    for c in chunks:
        contrib = c.T.float() @ c.float()
        g = contrib if g is None else g + contrib
    return g


def flash_attention_ref(q, k, v, *, scale=None, cap: float = 0.0,
                        causal: bool = True):
    """q: (B, T, Hq, hd), k/v: (B, T, Hkv, hd) with Hq % Hkv == 0.

    Scores, softmax and the P·V product run in fp32; the result is cast to
    q.dtype. For bf16 inputs the CUDA kernel, like the Pallas kernel, rounds
    P to bf16 before P·V (and the JAX oracle rounds s and p to bf16); that
    rounding is not repeated here (``flash_attention.flash_attention_tiled_ref``
    repeats the kernel's)."""
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, t, hkv, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    if causal:
        i = torch.arange(t, device=q.device)
        s = torch.where(i[:, None] >= i[None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, t, hq, hd).to(q.dtype)
