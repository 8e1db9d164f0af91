"""Theoretical quantities from the paper: gaps, bounds, projector distances
(port of ``repro/core/theory.py``).

Used by the tests (the bounds must hold empirically) and by the compression
path (the optimum bound beside every layer report).
"""
from __future__ import annotations

import torch

from repro_torch.core.coala import svdvals


def singular_gap(m: torch.Tensor, rank: int) -> torch.Tensor:
    """σ_r(M) − σ_{r+1}(M)."""
    s = svdvals(m)
    return s[rank - 1] - s[rank]


def thm1_bound(w: torch.Tensor, x: torch.Tensor, rank: int, mu: float
               ) -> torch.Tensor:
    """Theorem 1: ||W₀ − W_μ||_F ≤ 2‖W‖₂²‖W‖_F / (σ_r²−σ_{r+1}²)(WX) · μ.

    Holds with NO full-rank assumption on X (the degenerate/limited-data case).
    """
    s = svdvals(w @ x)
    gap2 = s[rank - 1] ** 2 - s[rank] ** 2
    w2 = torch.linalg.matrix_norm(w, ord=2)
    return 2.0 * w2 ** 2 * torch.linalg.norm(w) / gap2 * mu


def thm5_bound(w: torch.Tensor, x: torch.Tensor, rank: int, mu: float
               ) -> torch.Tensor:
    """Theorem 5 (full-row-rank X): ‖W‖₂‖W‖_F /(σ_r−σ_{r+1})(WX) · μ/σ_n(X)."""
    s_wx = svdvals(w @ x)
    gap = s_wx[rank - 1] - s_wx[rank]
    sx = svdvals(x)
    return (torch.linalg.matrix_norm(w, ord=2) * torch.linalg.norm(w) / gap
            * mu / sx[-1])


def projector_distance(u_a: torch.Tensor, u_b: torch.Tensor) -> torch.Tensor:
    """‖U_a U_aᵀ − U_b U_bᵀ‖₂ (Davis–Kahan–Wedin quantity, Thm. 4)."""
    return torch.linalg.matrix_norm(u_a @ u_a.T - u_b @ u_b.T, ord=2)


def relative_weighted_error(w: torch.Tensor, w_approx: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
    """||(W−W')X||_F / ||WX||_F — Figure 1's y-axis."""
    return torch.linalg.norm((w - w_approx) @ x) / torch.linalg.norm(w @ x)


def optimal_weighted_error(w: torch.Tensor, x: torch.Tensor, rank: int
                           ) -> torch.Tensor:
    """The attainable minimum of ||(W−W')X||_F = sqrt(Σ_{i>r} σ_i²(WX))."""
    s = svdvals(w @ x)
    return torch.sqrt(torch.sum(s[rank:] ** 2))
