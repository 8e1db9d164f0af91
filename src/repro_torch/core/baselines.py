"""Baselines the paper compares against (port of
``repro/core/baselines.py:25-88``; Appendix B + §2).

All are kept faithful, including their numerically fragile steps (explicit
Gram matrices, Cholesky of a possibly singular XXᵀ, inversion of small
singular values): reproducing those failures is part of the paper's claim.

  * ``svd_llm``      — Algorithm 3 [Wang et al. '25]: Cholesky of XXᵀ.
  * ``svd_llm_v2``   — Algorithm 4 [Wang et al. '25]: SVD of XXᵀ, S^{-1/2}.
  * ``asvd``         — activation-aware diagonal scaling [Yuan et al.].
  * ``plain_svd``    — context-free Eckart–Young–Mirsky on W.
  * ``corda``        — CorDA [Yang et al. '24]: Gram weighting with an
                       explicit inverse (Remark 1's fragile form).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.coala import svd


def _svd_trunc(m: torch.Tensor, rank: int):
    """Top-``rank`` SVD; NaN factors for a non-finite ``m`` (``svd``), so a
    failed Cholesky propagates as in the reference."""
    u, s, vt = svd(m)
    return u[:, :rank], s[:rank], vt[:rank, :]


def svd_llm(w: torch.Tensor, gram: torch.Tensor, rank: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SVD-LLM (Algorithm 3). gram = XXᵀ = SᵀS with S upper triangular;
    A = U_r, B = Σ_r V_rᵀ S^{-T} from the SVD of W·Sᵀ.

    ``jnp.linalg.cholesky`` returns a factor whose lower triangle is NaN
    where XXᵀ is not positive definite; ``torch.linalg.cholesky`` raises
    instead, so the factor comes from ``cholesky_ex`` and its lower
    triangle is set to NaN where ``info`` is non-zero — the factors are then
    non-finite, as in the reference (kept on purpose)."""
    low, info = torch.linalg.cholesky_ex(gram)
    low = torch.where(info == 0, low, float("nan")).tril()
    u, s, vt = _svd_trunc(w @ low, rank)          # W·Sᵀ with Sᵀ = L
    # B = Σ_r V_rᵀ S^{-T}: Bᵀ solves L·Bᵀ = (Σ_r V_rᵀ)ᵀ (the reference's
    # solve_triangular(S, ·, lower=False, trans="T"))
    b = torch.linalg.solve_triangular(low, (s[:, None] * vt).T, upper=False).T
    return u, b


def svd_llm_v2(w: torch.Tensor, gram: torch.Tensor, rank: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SVD-LLM v2 (Algorithm 4): decompose XXᵀ = Us diag(sv) Usᵀ, truncate
    the SVD of W Us S^{1/2}, map back with S^{-1/2} (0 where sv == 0; it
    blows up where sv is tiny, as in the reference)."""
    us, sv, _ = svd(gram)
    m = w @ (us * torch.sqrt(sv)[None, :])
    u, s, vt = _svd_trunc(m, rank)
    inv_sqrt = torch.where(sv > 0, 1.0 / torch.sqrt(sv), torch.zeros_like(sv))
    b = (s[:, None] * vt) @ (us * inv_sqrt[None, :]).T
    return u, b


def asvd(w: torch.Tensor, x: torch.Tensor, rank: int, alpha: float = 0.5
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ASVD: W ≈ (W S) S^{-1} with diagonal S_ii = (mean_k |X_ik|)^alpha."""
    act = torch.mean(torch.abs(x), dim=1)
    scale = torch.clamp(act, min=1e-6) ** alpha
    u, s, vt = _svd_trunc(w * scale[None, :], rank)
    b = (s[:, None] * vt) / scale[None, :]
    return u, b


def plain_svd(w: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Context-free EYM truncation of W itself."""
    u, s, vt = _svd_trunc(w, rank)
    return u, s[:, None] * vt


def corda(w: torch.Tensor, x: torch.Tensor, rank: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CorDA (Remark 1): W' = U_r Σ_r V_rᵀ (XXᵀ)^{-1} from the SVD of W·XXᵀ.

    ``jnp.linalg.solve`` returns non-finite values for an exactly singular
    Gram; ``torch.linalg.solve`` raises, so the port solves with
    ``solve_ex`` and returns NaN where ``info`` is non-zero (kept on
    purpose: the failure is the paper's point)."""
    gram = x @ x.T
    u, s, vt = _svd_trunc(w @ gram, rank)
    sol, info = torch.linalg.solve_ex(gram.T, (s[:, None] * vt).T)
    b = torch.where(info == 0, sol, float("nan")).T
    return u, b
