"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

The paged-attention and chunked-prefill plain versions live beside their
kernels, as in the JAX package."""
from __future__ import annotations


def lowrank_linear_ref(x, b_t, a_t):
    """y = (x @ b_t) @ a_t — COALA factored linear. x: (..., d_in)."""
    return (x @ b_t) @ a_t
