"""COALA: inversion-free, regularized context-aware low-rank approximation
(port of ``repro/core/coala.py``).

  * Prop. 1/2 — ``W' = U_r U_rᵀ W`` with U_r the top-r left singular vectors
    of ``W Rᵀ`` where ``QR = Xᵀ`` (Algorithm 1). No Gram matrix, no inverse.
  * Prop. 3 — the μ-regularized problem is the unregularized one with
    X̃ = [X √μ I] (Algorithm 2), μ per layer from the paper's Eq. (5).
  * Prop. 4 — the (XXᵀ)^α family unifying PiSSA (α=0), COALA (α=1) and
    a robustified CorDA (α=2), used for adapter initialization.
  * Beyond the paper: a randomized range finder (``rsvd_left_singvecs``)
    that computes only the top-r subspace with matmuls and thin QRs.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import torch

from repro_torch.core import tsqr as tsqr_lib


def _solver(m: torch.Tensor):
    """cuSOLVER's QR-based ``gesvd`` for a CUDA tensor (None elsewhere).
    PyTorch's default there, the Jacobi ``gesvdj``, stops at a tolerance
    relative to σ_max, so on W Rᵀ of a calibration R (σ_max / σ_r ~ 1e7 on
    llama3_1b's ``down``) its tail singular vectors are off and the COALA
    factors miss the attainable weighted error by orders of magnitude;
    ``gesvd`` reaches it within fp32's floor (``chip_smoke.py`` phase 10c
    holds it there; ``tools/torch_svd_probe.py`` compares both drivers).
    Its cost depends on the matrix: on an H100 it is slower than
    ``gesvdj`` on a random full-rank 1408 × 2048 matrix (0.23 against
    0.09 s; the shape of a λ-driven expert's μ-augmented second solve),
    as fast on an expert's zero-padded W Rᵀ, and faster on llama3_1b's
    2048² W Rᵀ."""
    return "gesvd" if m.is_cuda else None


def svd(m: torch.Tensor):
    """Reduced SVD (U, S, Vᵀ) of ``m`` (see ``_solver``). Where ``m`` holds
    a non-finite value ``jnp.linalg.svd`` returns all-NaN factors, while
    ``torch.linalg.svd`` raises — and cuSOLVER's ``gesvd`` first iterates
    for long (92 s on a 512² NaN matrix on an H100) — so the port returns
    the NaN factors without a solve, as the reference does."""
    if not bool(torch.isfinite(m).all()):
        k = min(m.shape)
        nan = dict(fill_value=float("nan"), dtype=m.dtype, device=m.device)
        return (torch.full((m.shape[0], k), **nan), torch.full((k,), **nan),
                torch.full((k, m.shape[1]), **nan))
    return torch.linalg.svd(m, full_matrices=False, driver=_solver(m))


def svdvals(m: torch.Tensor) -> torch.Tensor:
    """Singular values of ``m``, descending (see ``_solver``); all NaN for
    a non-finite ``m``, as ``svd``."""
    if not bool(torch.isfinite(m).all()):
        return torch.full((min(m.shape),), float("nan"), dtype=m.dtype,
                          device=m.device)
    return torch.linalg.svdvals(m, driver=_solver(m))


def _topk_left_singvecs(m: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r left singular vectors of m via full SVD (paper-faithful path)."""
    return svd(m)[0][:, :r]


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
    ub = svd(q.T @ m)[0]
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


def coala_project(w, x=None, *, r_factor=None, rank: int, **kw) -> torch.Tensor:
    """Convenience: the rank-r approximation W' itself."""
    return coala_factors(w, x, r_factor=r_factor, rank=rank, **kw).w_approx


def mu_from_lambda(w: torch.Tensor, w0: torch.Tensor, r_factor: torch.Tensor,
                   lam: float) -> torch.Tensor:
    """Paper Eq. (5): μ = λ · ||(W₀−W)X||²_F / ||W₀−W||²_F, using
    ||(W₀−W)X||_F = ||(W₀−W)Rᵀ||_F so no X is needed."""
    diff = w0 - w
    num = torch.sum((diff @ r_factor.T) ** 2)
    den = torch.sum(diff ** 2)
    return lam * num / torch.clamp(den, min=torch.finfo(w.dtype).tiny)


# ---------------------------------------------------------------------------
# Proposition 4 — the α-family (adapter initialization)
# ---------------------------------------------------------------------------

def alpha_weight_factor(x_or_r: torch.Tensor, alpha: float, *,
                        is_r: bool = False) -> torch.Tensor:
    """Return S_α with S_α S_αᵀ = (XXᵀ)^α, computed inversion-free.

    From the SVD of Xᵀ = Q Σ Vᵀ (or of R): (XXᵀ)^{α/2} = V Σ^α Vᵀ.
    α=0 → I (PiSSA), α=1 → (XXᵀ)^{1/2} (COALA), α=2 → XXᵀ (CorDA, robustified:
    formed from singular values of X, never from an explicit Gram matrix).
    With fewer rows than n, the missing singular values are 0 (and 0^0 = 1,
    as in the reference).
    """
    mat = x_or_r if is_r else x_or_r.T          # rows = tokens/R-rows, cols = n
    _, s, vt = svd(mat)
    n = mat.shape[1]
    s_full = torch.zeros((n,), dtype=mat.dtype, device=mat.device)
    s_full[: s.shape[0]] = s
    v = torch.zeros((n, n), dtype=mat.dtype, device=mat.device)
    v[:, : vt.shape[0]] = vt.T
    return (v * (s_full ** alpha)[None, :]) @ v.T


def coala_alpha_factors(w: torch.Tensor, x: Optional[torch.Tensor] = None, *,
                        r_factor: Optional[torch.Tensor] = None, rank: int,
                        alpha: float = 1.0, mu: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prop. 4 solution: W' = U_r U_rᵀ W with U_r from SVD(W (XXᵀ)^{α/2}).

    Returns (A, B) = (U_r, U_rᵀ W). For α=1 this coincides with Algorithm 1.
    """
    if (x is None) == (r_factor is None):
        raise ValueError("pass exactly one of x / r_factor")
    if mu < 0.0:
        raise ValueError(f"mu must be non-negative, got {mu}")
    if alpha == 1.0 and mu == 0.0:
        res = coala_factors(w, x, r_factor=r_factor, rank=rank)
        return res.a, res.b
    src = r_factor if r_factor is not None else x
    s_alpha = alpha_weight_factor(src, alpha, is_r=r_factor is not None)
    if mu > 0.0:
        # (XXᵀ)^α + μI via augmented-R of S_α (S_α is symmetric, rows = n)
        s_alpha = tsqr_lib.augment_r_with_mu(tsqr_lib.qr_r(s_alpha), mu).T
    u_r = _topk_left_singvecs(w @ s_alpha, rank)
    return u_r, u_r.T @ w


def balanced_split(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rebalance (A, B) so both factors have comparable scale: per index i
    the scale ``sqrt(||B row_i|| / ||A col_i||)`` moves both norms to their
    geometric mean (adapter init: gradients are better conditioned when
    ||A col_i|| ≈ ||B row_i||)."""
    eps = torch.finfo(b.dtype).eps
    bn = torch.clamp(torch.linalg.norm(b, dim=1), min=eps)    # (r,)
    an = torch.clamp(torch.linalg.norm(a, dim=0), min=eps)    # (r,)
    rn = torch.sqrt(bn / an)
    return a * rn[None, :], b / rn[:, None]


# ---------------------------------------------------------------------------
# Reference (Eckart–Young–Mirsky) building block
# ---------------------------------------------------------------------------

def eym_truncate(a: torch.Tensor, rank: int) -> torch.Tensor:
    """Best rank-r approximation of ``a`` in Frobenius norm (Theorem 3)."""
    u, s, vt = svd(a)
    return (u[:, :rank] * s[:rank][None, :]) @ vt[:rank, :]


def weighted_error(w: torch.Tensor, w_approx: torch.Tensor, x: torch.Tensor
                   ) -> torch.Tensor:
    """||(W − W')X||_F — the objective of problem (3)."""
    return torch.linalg.norm((w - w_approx) @ x)
