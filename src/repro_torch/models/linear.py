"""Dense ⟷ low-rank factored linear layers (port of ``repro/models/linear.py``).

COALA's output is a pair (A, B) with W' = A·B. A ``Linear`` holds either the
dense ``w`` (d_in, d_out) or the factored ``b_t = Bᵀ`` (d_in, r) and
``a_t = Aᵀ`` (r, d_out), so a compressed model differs from a dense one only
in which parameters its projections hold:

    y = x @ W' = x @ (A B)ᵀ = (x @ Bᵀ) @ Aᵀ

The factored path goes through ``kernels.ops.lowrank_linear`` (the CUDA
kernel on a CUDA tensor). Calibration capture attaches a forward pre-hook
(``core/calibrate.py``) in place of the JAX package's ``CaptureDict``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class Linear(torch.nn.Module):
    """One projection: dense ``w`` or factored ``b_t``/``a_t`` parameters."""

    def __init__(self, d_in: int, d_out: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(
            torch.zeros((d_in, d_out), device=device, dtype=dtype))

    @property
    def is_factored(self) -> bool:
        return "b_t" in self._parameters

    def set_dense(self, w: torch.Tensor) -> None:
        for name in ("b_t", "a_t"):
            self._parameters.pop(name, None)
        self.w = torch.nn.Parameter(w)

    def set_factors(self, b_t: torch.Tensor, a_t: torch.Tensor) -> None:
        self._parameters.pop("w", None)
        self.b_t = torch.nn.Parameter(b_t.contiguous())
        self.a_t = torch.nn.Parameter(a_t.contiguous())

    def forward(self, x):
        if self.is_factored:
            return ops.lowrank_linear(x.contiguous(), self.b_t.to(x.dtype),
                                      self.a_t.to(x.dtype))
        return x @ self.w.to(x.dtype)


def linear_weight_matrix(lin: Linear) -> torch.Tensor:
    """The (d_out, d_in) matrix view W_mat for compression (COALA's W),
    detached from autograd."""
    if lin.is_factored:
        return (lin.b_t @ lin.a_t).T.detach()
    return lin.w.T.detach()


def rank_for_ratio(d_in: int, d_out: int, ratio: float) -> int:
    """Largest rank whose factored cost ≤ ratio · dense cost (≥1)."""
    return max(1, int((ratio * d_in * d_out) // (d_in + d_out)))
