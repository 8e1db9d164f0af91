"""COALA: inversion-free, regularized context-aware low-rank approximation
(port of ``repro/core/coala.py:33-160``).

  * Prop. 1/2 — ``W' = U_r U_rᵀ W`` with U_r the top-r left singular vectors
    of ``W Rᵀ`` where ``QR = Xᵀ`` (Algorithm 1). No Gram matrix, no inverse.
  * Prop. 3 — the μ-regularized problem is the unregularized one with
    X̃ = [X √μ I] (Algorithm 2), μ per layer from the paper's Eq. (5).
  * Beyond the paper: a randomized range finder (``rsvd_left_singvecs``)
    that computes only the top-r subspace with matmuls and thin QRs.

The α-family (Prop. 4) waits for a later slice.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.core import tsqr as tsqr_lib


def _topk_left_singvecs(m: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r left singular vectors of m via full SVD (paper-faithful path)."""
    u, _, _ = torch.linalg.svd(m, full_matrices=False)
    return u[:, :r]


def rsvd_left_singvecs(m: torch.Tensor, r: int, *, oversample: int = 8,
                       power_iters: int = 2, seed: int = 0) -> torch.Tensor:
    """Randomized range finder for the top-r left subspace of ``m``
    (Halko–Martinsson–Tropp with QR-stabilized power iterations). The
    Gaussian sketch comes from a ``torch.Generator`` seeded with ``seed`` on
    ``m``'s device, so it differs from jax.random's: compare subspaces."""
    mm, nn = m.shape
    l = min(r + oversample, nn)
    gen = torch.Generator(device=m.device).manual_seed(seed)
    omega = torch.randn((nn, l), generator=gen, device=m.device, dtype=m.dtype)
    q, _ = torch.linalg.qr(m @ omega)
    for _ in range(power_iters):
        z, _ = torch.linalg.qr(m.T @ q)
        q, _ = torch.linalg.qr(m @ z)
    ub, _, _ = torch.linalg.svd(q.T @ m, full_matrices=False)
    return (q @ ub)[:, :r]


@dataclasses.dataclass(frozen=True)
class CoalaResult:
    a: torch.Tensor          # (m, r)
    b: torch.Tensor          # (r, n)
    mu: float                # μ actually used
    r_factor: torch.Tensor   # the (possibly μ-augmented) R that was factored

    @property
    def w_approx(self) -> torch.Tensor:
        return self.a @ self.b


def r_from_x(x: torch.Tensor, chunk_tokens: int = 0) -> torch.Tensor:
    """R factor of qr(Xᵀ) for X (n, k); optionally via streaming TSQR chunks."""
    xt = x.T
    if chunk_tokens and xt.shape[0] > chunk_tokens:
        chunks = [xt[i:i + chunk_tokens]
                  for i in range(0, xt.shape[0], chunk_tokens)]
        r = tsqr_lib.tsqr_sequential(chunks)
    else:
        r = tsqr_lib.qr_r(xt)
    return tsqr_lib.square_r(r)


def _factor_from_r(w: torch.Tensor, r_factor: torch.Tensor, r: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    u_r = _topk_left_singvecs(w @ r_factor.T, r)
    return u_r, u_r.T @ w


def _factor_from_r_rsvd(w: torch.Tensor, r_factor: torch.Tensor, r: int, *,
                        oversample: int, power_iters: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    u_r = rsvd_left_singvecs(w @ r_factor.T, r, oversample=oversample,
                             power_iters=power_iters)
    return u_r, u_r.T @ w


def coala_factors(w: torch.Tensor, x: Optional[torch.Tensor] = None, *,
                  r_factor: Optional[torch.Tensor] = None, rank: int,
                  mu: float = 0.0, lam: Optional[float] = None,
                  use_rsvd: bool = False, rsvd_oversample: int = 8,
                  rsvd_power_iters: int = 2,
                  chunk_tokens: int = 0) -> CoalaResult:
    """COALA Algorithm 1/2. Provide either ``x`` (n, k) or a precomputed
    ``r_factor`` (n, n) from the calibration pipeline.

    mu/lam: explicit μ, or λ-driven Eq. (5) selection when ``lam`` is given
    (μ = λ · ||W₀X − WX||²_F / ||W₀ − W||²_F, computed from R only).
    """
    if (x is None) == (r_factor is None):
        raise ValueError("pass exactly one of x / r_factor")
    if r_factor is None:
        r_factor = r_from_x(x, chunk_tokens)
    r_factor = tsqr_lib.square_r(r_factor)
    solve = (partial(_factor_from_r_rsvd, oversample=rsvd_oversample,
                     power_iters=rsvd_power_iters)
             if use_rsvd else _factor_from_r)
    if lam is not None:
        a0, b0 = solve(w, r_factor, rank)
        mu = float(mu_from_lambda(w, a0 @ b0, r_factor, lam))
    r_used = tsqr_lib.augment_r_with_mu(r_factor, mu) if mu > 0.0 else r_factor
    a, b = solve(w, r_used, rank)
    return CoalaResult(a=a, b=b, mu=float(mu), r_factor=r_used)


def mu_from_lambda(w: torch.Tensor, w0: torch.Tensor, r_factor: torch.Tensor,
                   lam: float) -> torch.Tensor:
    """Paper Eq. (5): μ = λ · ||(W₀−W)X||²_F / ||W₀−W||²_F, using
    ||(W₀−W)X||_F = ||(W₀−W)Rᵀ||_F so no X is needed."""
    diff = w0 - w
    num = torch.sum((diff @ r_factor.T) ** 2)
    den = torch.sum(diff ** 2)
    return lam * num / torch.clamp(den, min=torch.finfo(w.dtype).tiny)
