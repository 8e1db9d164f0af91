"""Dense ⟷ low-rank factored linear layers (port of ``repro/models/linear.py``).

COALA's output is a pair (A, B) with W' = A·B. A ``Linear`` holds the dense
``w`` (d_in, d_out), the factored ``b_t = Bᵀ`` (d_in, r) and ``a_t = Aᵀ``
(r, d_out), or all three — a dense residual plus a trainable low-rank
adapter (``core/adapters.py``), whose outputs it sums as the reference's
``linear_apply`` does. So a compressed or adapted model differs from a dense
one only in which parameters its projections hold:

    y = x @ W' = x @ (A B)ᵀ = (x @ Bᵀ) @ Aᵀ

The factored product goes through ``kernels.ops.lowrank_linear`` (the CUDA
kernel on a CUDA tensor, under autograd too). Calibration capture attaches a forward pre-hook
(``core/calibrate.py``) in place of the JAX package's ``CaptureDict``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class Linear(torch.nn.Module):
    """One projection: dense ``w``, factored ``b_t``/``a_t``, or both."""

    def __init__(self, d_in: int, d_out: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(
            torch.zeros((d_in, d_out), device=device, dtype=dtype))

    @property
    def is_factored(self) -> bool:
        """Holds ``b_t``/``a_t`` (with or without ``w``), as the reference's
        ``is_factored``."""
        return "b_t" in self._parameters

    @property
    def has_dense(self) -> bool:
        """Holds ``w`` (alone or beside an adapter): the reference's walks
        that compress or capture a linear ask for ``"w" in node``."""
        return "w" in self._parameters

    def set_dense(self, w: torch.Tensor) -> None:
        for name in ("b_t", "a_t"):
            self._parameters.pop(name, None)
        self.w = torch.nn.Parameter(w)

    def set_factors(self, b_t: torch.Tensor, a_t: torch.Tensor) -> None:
        self._parameters.pop("w", None)
        self.b_t = torch.nn.Parameter(b_t.contiguous())
        self.a_t = torch.nn.Parameter(a_t.contiguous())

    def set_adapter(self, w: torch.Tensor, b_t: torch.Tensor,
                    a_t: torch.Tensor) -> None:
        """Hold the dense residual ``w`` and the adapter ``b_t``/``a_t``."""
        self.set_factors(b_t, a_t)
        self.w = torch.nn.Parameter(w)

    def forward(self, x):
        if not self.is_factored:
            return x @ self.w.to(x.dtype)
        lr = ops.lowrank_linear(x.contiguous(), self.b_t.to(x.dtype),
                                self.a_t.to(x.dtype))
        if not self.has_dense:
            return lr
        return x @ self.w.to(x.dtype) + lr


def linear_weight_matrix(lin: Linear) -> torch.Tensor:
    """The (d_out, d_in) matrix view W_mat for compression (COALA's W),
    detached from autograd: ``w`` where the linear holds one (an adapter is
    left out, as in the reference), else ``(b_t a_t)ᵀ``."""
    if lin.has_dense:
        return lin.w.T.detach()
    return (lin.b_t @ lin.a_t).T.detach()


def rank_for_ratio(d_in: int, d_out: int, ratio: float) -> int:
    """Largest rank whose factored cost ≤ ratio · dense cost (≥1)."""
    return max(1, int((ratio * d_in * d_out) // (d_in + d_out)))
