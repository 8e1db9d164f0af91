"""Theoretical quantities from the paper (port of ``repro/core/theory.py:51``;
the other bounds wait)."""
from __future__ import annotations

import torch


def optimal_weighted_error(w: torch.Tensor, x: torch.Tensor, rank: int
                           ) -> torch.Tensor:
    """The attainable minimum of ||(W−W')X||_F = sqrt(Σ_{i>r} σ_i²(WX))."""
    s = torch.linalg.svdvals(w @ x)
    return torch.sqrt(torch.sum(s[rank:] ** 2))
