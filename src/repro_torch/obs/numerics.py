"""Numerical-health monitors (port of ``repro/obs/numerics.py``): make
COALA's silent failure modes visible.

A near-singular activation Gram matrix crashes nothing: it degrades the
projection quietly, and the insufficient-data regime is safe only when
explicit bounds say enough calibration has been seen. These monitors turn
both into observables:

  * **Condition number of each layer's streamed R factor** —
    ``triangular_cond`` estimates cond₁(R) from the triangular factor alone
    (one triangular solve, ``torch.linalg.solve_triangular``): no Gram
    matrix is formed, so the estimate cannot square the conditioning.
    cond(R) = cond(X).
  * **Insufficient data** — fewer calibration tokens than the layer's
    feature count leaves R rank-deficient (the paper's scenario (3));
    flagged from ``tokens_seen``.
  * **Projection residual vs. the attainable bound** — each compressed
    layer's ``‖(W−W')Rᵀ‖/‖WRᵀ‖`` against the Σ-tail minimum
    (``core/theory.py``'s ``optimal_weighted_error``).

``NumericsPolicy`` maps measurements to ``ok | warn | fail`` with the JAX
package's thresholds. The factors may live on any device; the grades are
computed in fp32 where they lie.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from repro_torch.core.tsqr import augment_r_with_mu

OK, WARN, FAIL = "ok", "warn", "fail"
_RANK = {OK: 0, WARN: 1, FAIL: 2}


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """Warn/fail thresholds (the JAX package's, docs/observability.md)."""
    warn_cond: float = 1e6          # fp32 entrywise accuracy of R eroding
    fail_cond: float = 1e8          # past ~1/eps32: R trustworthy only up
    #                                 to an orthogonal factor; Gram paths dead
    min_token_factor: float = 1.0   # tokens_seen < factor * n => rank-
    #                                 deficient R (insufficient-data regime)
    warn_residual_excess: float = 2.0   # achieved residual vs attainable
    fail_residual_excess: float = 10.0  # bound: solver silently lost accuracy


@dataclasses.dataclass
class LayerHealth:
    """One layer's verdict; ``reasons`` carries the human-readable why."""
    path: str
    level: str                       # ok | warn | fail
    cond: float = float("nan")
    tokens: Optional[int] = None
    n: int = 0
    residual: float = float("nan")
    bound: float = float("nan")
    reasons: List[str] = dataclasses.field(default_factory=list)


def _as_f32(r) -> torch.Tensor:
    return torch.as_tensor(r).to(torch.float32)


def triangular_cond(r) -> float:
    """cond₁(R) of an upper-triangular (n, n) R — one triangular solve, no
    Gram. Returns ``inf`` for a singular or non-finite factor."""
    r = _as_f32(r)
    n = r.shape[0]
    if not bool(torch.isfinite(r).all()) or \
            float(torch.diagonal(r).abs().min()) == 0.0:
        return float("inf")
    rinv = torch.linalg.solve_triangular(
        r, torch.eye(n, dtype=r.dtype, device=r.device), upper=True)
    if not bool(torch.isfinite(rinv).all()):
        return float("inf")

    def norm1(a):
        return float(a.abs().sum(dim=0).max())

    return norm1(r) * norm1(rinv)


def _grade(value: float, warn: float, fail: float) -> str:
    if not math.isfinite(value) or value >= fail:
        return FAIL
    return WARN if value >= warn else OK


def check_r_factors(r_factors: Dict[str, object],
                    tokens_seen: Optional[Dict[str, int]] = None,
                    policy: NumericsPolicy = NumericsPolicy()
                    ) -> List[LayerHealth]:
    """Grade every calibrated layer's R factor: conditioning + data volume."""
    out: List[LayerHealth] = []
    for path, r in r_factors.items():
        n = int(r.shape[0])
        cond = triangular_cond(r)
        tokens = tokens_seen.get(path) if tokens_seen else None
        level = _grade(cond, policy.warn_cond, policy.fail_cond)
        reasons = []
        if level != OK:
            reasons.append(
                f"cond(R)={cond:.2e} (warn>={policy.warn_cond:.0e}, "
                f"fail>={policy.fail_cond:.0e})")
        if tokens is not None and tokens < policy.min_token_factor * n:
            level = max(level, WARN, key=_RANK.get)
            reasons.append(
                f"insufficient data: {tokens} calibration tokens < "
                f"{policy.min_token_factor:g} x {n} features "
                f"(rank-deficient R)")
        out.append(LayerHealth(path=path, level=level, cond=cond,
                               tokens=tokens, n=n, reasons=reasons))
    return out


def check_augmented_r_factors(r_factors: Dict[str, object],
                              mus: Dict[str, float],
                              tokens_seen: Optional[Dict[str, int]] = None,
                              policy: NumericsPolicy = NumericsPolicy()
                              ) -> List[LayerHealth]:
    """Grade the μ-augmented factors R̃ = qr([R; √μ I]), the matrices a
    regularized COALA solve uses (Prop. 3). Under-streamed R is singular by
    construction, so the live recalibration gate grades R̃ instead.
    ``mus``: per-path μ the solve used (``LayerReport.mu``); a path with
    μ <= 0 is graded raw."""
    aug = {}
    for path, r in r_factors.items():
        mu = float(mus.get(path, 0.0))
        r = _as_f32(r)
        aug[path] = augment_r_with_mu(r, mu) if mu > 0.0 else r
    return check_r_factors(aug, tokens_seen, policy)


def check_calibration(cal, policy: NumericsPolicy = NumericsPolicy()
                      ) -> List[LayerHealth]:
    """Health of a finished calibration (anything with ``r_factors()`` /
    ``tokens_seen()``)."""
    return check_r_factors(cal.r_factors(), cal.tokens_seen(), policy)


def check_compression(reports, policy: NumericsPolicy = NumericsPolicy()
                      ) -> List[LayerHealth]:
    """Grade per-layer projection residuals against the attainable bound
    (``reports``: ``LayerReport`` list from ``core/compress.py``)."""
    out: List[LayerHealth] = []
    for rep in reports:
        res, bound = rep.rel_err_weighted, getattr(rep, "rel_err_bound",
                                                   float("nan"))
        if not (math.isfinite(res) and math.isfinite(bound)):
            continue                # a layer without an R factor
        excess = res / max(bound, 1e-12)
        level = _grade(excess, policy.warn_residual_excess,
                       policy.fail_residual_excess)
        reasons = [] if level == OK else [
            f"residual {res:.3e} is {excess:.1f}x the attainable bound "
            f"{bound:.3e} (warn>={policy.warn_residual_excess:g}x)"]
        out.append(LayerHealth(path=rep.path, level=level, residual=res,
                               bound=bound, reasons=reasons))
    return out


def worst_level(healths: List[LayerHealth]) -> str:
    return max((h.level for h in healths), key=_RANK.get, default=OK)


def format_report(healths: List[LayerHealth], *, only_flagged: bool = False
                  ) -> str:
    """Fixed-width table + one WARN/FAIL line per flagged layer."""
    lines = [f"{'level':5}  {'cond(R)':>9}  {'tokens':>7}  "
             f"{'resid/bound':>12}  path"]
    n_flag = 0
    for h in sorted(healths, key=lambda h: (-_RANK[h.level], h.path)):
        if only_flagged and h.level == OK:
            continue
        ratio = (f"{h.residual / max(h.bound, 1e-12):10.1f}x"
                 if math.isfinite(h.residual) else f"{'-':>11}")
        cond = (f"{h.cond:9.2e}" if math.isfinite(h.cond)
                else f"{'-' if math.isnan(h.cond) else 'inf':>9}")
        tokens = f"{h.tokens}" if h.tokens is not None else "-"
        lines.append(f"{h.level:5}  {cond}  {tokens:>7}  {ratio:>12}  "
                     f"{h.path}")
        if h.level != OK:
            n_flag += 1
            lines.append(f"  NUMERICS {h.level.upper()} {h.path}: "
                         + "; ".join(h.reasons))
    lines.append(f"numerics: {len(healths)} layers checked, "
                 f"{n_flag} flagged, worst={worst_level(healths)}")
    return "\n".join(lines)
