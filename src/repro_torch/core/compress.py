"""Model-wide compression (port of ``repro/core/compress.py:28-207``,
``:209-316``).

For every compressible block linear with a calibrated R factor, solve the
context-aware low-rank problem — COALA (Algorithm 1/2 with the per-layer μ
of Eq. 5, full or randomized SVD) or one of the baselines (svd, svd_llm,
svd_llm_v2, asvd) — and swap the dense ``w`` for the factored ``b_t``/``a_t``
pair. ``compress_model_pair`` builds a speculative-decoding target and its
harder-compressed draft from one calibration pass. ``rank_map`` (full
path -> rank, from ``rank_map_from_reports``) pins per-layer ranks over
``ratio`` and ``rank``, so a recompression keeps every factor's shape (live
recalibration's hot swap needs that).

MoE expert banks are compressed per expert (``repro/core/compress.py:
99-146``), each from the R factor of the tokens routed to it — the paper's
limited-data regime, where μ carries the solve: a routed expert sees few
tokens, so its R is rank-deficient. An expert no calibration token reached
keeps the plain-SVD (Eckart–Young–Mirsky) factors and a NaN report. As in
the reference, a per-expert report records ``mu=0.0`` whatever μ its solve
used. With ``ccfg.adaptive_rank`` the ranks of the dense linears come from
``core/rank_alloc.py``'s water-filling over σ²(W Rᵀ) (expert banks keep the
ratio's rank, as in the reference).
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import CompressConfig
from repro_torch.core import baselines as bl
from repro_torch.core import coala as coala_lib
from repro_torch.core.calibrate import block_modules
from repro_torch.core.rank_alloc import adaptive_rank_map
from repro_torch.core.theory import optimal_weighted_error
from repro_torch.core.tsqr import square_r
from repro_torch.models.ffn import MoE
from repro_torch.models.linear import Linear, rank_for_ratio

# layer-name roles eligible for compression (Q,K,V,O,Up,Gate,Down and the
# other families' projections; embeddings, heads and norms stay)
COMPRESSIBLE_KEYS = {"wq", "wk", "wv", "wo", "up", "gate", "down",
                     "in_proj", "out_proj", "ff_up", "ff_down",
                     "w_dkv", "shared"}
MIN_DIM = 32


def compressible(path: Tuple[str, ...], shape, cfg=None) -> bool:
    """Is the linear at ``path`` (to its dict or its 'w' leaf) a target?
    ``cfg`` is unused and no caller passes it: it is kept only for the
    reference's signature (``launch/dryrun.py`` there passes it)."""
    names = [str(p) for p in path]
    if names and names[-1] == "w":
        names = names[:-1]
    key = names[-1] if names else ""
    if key not in COMPRESSIBLE_KEYS - {"shared"}:
        return False
    d_in, d_out = shape[-2], shape[-1]
    return min(d_in, d_out) >= MIN_DIM


@dataclasses.dataclass
class LayerReport:
    path: str
    rank: int
    mu: float
    rel_err_weighted: float      # ||(W-W')R^T||/||W R^T||
    params_before: int
    params_after: int
    # attainable minimum of the same ratio (Σ-tail of σ(W Rᵀ)) / ||W Rᵀ||
    rel_err_bound: float = float("nan")


def _solve(w_mat, r_factor, rank, ccfg: CompressConfig):
    """Dispatch on method. w_mat: (d_out, d_in) matrix view. The Gram-based
    baselines take XXᵀ = RᵀR; asvd takes Rᵀ as its activation proxy."""
    if ccfg.method == "coala":
        res = coala_lib.coala_factors(
            w_mat, r_factor=r_factor, rank=rank,
            mu=max(ccfg.mu, 0.0) if ccfg.mu >= 0 else 0.0,
            lam=ccfg.lam if ccfg.mu < 0 else None,
            use_rsvd=ccfg.use_rsvd, rsvd_oversample=ccfg.rsvd_oversample,
            rsvd_power_iters=ccfg.rsvd_power_iters)
        return res.a, res.b, res.mu
    if ccfg.method == "svd":
        a, b = bl.plain_svd(w_mat, rank)
        return a, b, 0.0
    if ccfg.method == "svd_llm":
        a, b = bl.svd_llm(w_mat, r_factor.T @ r_factor, rank)
        return a, b, 0.0
    if ccfg.method == "svd_llm_v2":
        a, b = bl.svd_llm_v2(w_mat, r_factor.T @ r_factor, rank)
        return a, b, 0.0
    if ccfg.method == "asvd":
        # diagonal scale from R (mean |col| proxy for mean |activation|)
        a, b = bl.asvd(w_mat, r_factor.T, rank)
        return a, b, 0.0
    raise ValueError(f"unknown method {ccfg.method}")


def _rank(d_in: int, d_out: int, ccfg: CompressConfig) -> int:
    rank = (ccfg.rank if ccfg.rank > 0
            else rank_for_ratio(d_in, d_out, ccfg.ratio))
    return min(rank, min(d_in, d_out))


def _compress_experts(moe: MoE, p: str, r_factors, ccfg: CompressConfig,
                      reports: List[LayerReport]) -> None:
    """Per-expert solve of each dense bank of ``moe`` at path ``p``; the
    stacks become factored banks b_t (E, d_in, r), a_t (E, r, d_out) in the
    bank's dtype. A bf16 expert meets the fp32 R and factors as fp32, where
    the reference's products promote it."""
    for mat, rf_kind in (("w_gate", "in"), ("w_up", "in"), ("w_down", "hid")):
        bank = getattr(moe, mat)
        if bank.is_factored:
            continue
        w_stack = bank.w
        bts, ats = [], []
        for e in range(w_stack.shape[0]):
            rf = r_factors.get(f"{p}/expert{e}/{rf_kind}")
            w_mat = w_stack[e].T.float()                  # (d_out, d_in)
            d_out, d_in = w_mat.shape
            rank = _rank(d_in, d_out, ccfg)
            if rf is None:
                # expert never routed to during calibration: keep the
                # EYM projection (X=I ⇒ μ-regularized limit, Prop. 3)
                a, b = bl.plain_svd(w_mat, rank)
                rel_err = bound = float("nan")
            else:
                rf = square_r(rf).float()
                a, b, _ = _solve(w_mat, rf, rank, ccfg)
                den = torch.clamp(torch.linalg.norm(w_mat @ rf.T), min=1e-9)
                rel_err = float(torch.linalg.norm((w_mat - a @ b) @ rf.T) / den)
                bound = float(optimal_weighted_error(w_mat, rf.T, rank) / den)
            bts.append(b.T.to(w_stack.dtype))
            ats.append(a.T.to(w_stack.dtype))
            reports.append(LayerReport(
                path=f"{p}/{mat}/e{e}", rank=rank, mu=0.0,
                rel_err_weighted=rel_err, params_before=d_in * d_out,
                params_after=rank * (d_in + d_out), rel_err_bound=bound))
        bank.set_factors(torch.stack(bts), torch.stack(ats))


@torch.no_grad()
def adaptive_ranks(model, r_factors, ratio: float) -> Dict[str, int]:
    """``adaptive_rank_map`` over the weights the reference's branch of
    ``compress_model`` collects (``repro/core/compress.py:222-243``): every
    linear holding ``w`` that has an R factor (thin or square) and is
    compressible; MoE expert banks stay out (they are not 2-D ``w`` leaves
    there either)."""
    weights = {p: lin.w for p, lin in block_modules(model, Linear)
               if lin.has_dense and p in r_factors
               and compressible(tuple(p.split("/")) + ("w",), lin.w.shape)}
    return adaptive_rank_map(weights, {p: square_r(r_factors[p])
                                       for p in weights}, ratio)


@torch.no_grad()
def compress_model(model, calibrator, ccfg: CompressConfig, *,
                   rank_map: Optional[Dict[str, int]] = None):
    """Calibrator R factors -> (compressed copy of ``model``, reports).

    Paths are the calibrator's ('blocks/2/sub0/mixer/wq'); every rep of the
    stack is compressed from its own activations, as in the paper.
    ``rank_map`` (full path -> rank) overrides ``ccfg.ratio`` and
    ``ccfg.rank`` for the paths it names (not for expert banks, whose ranks
    always come from ``ccfg``), and ``ccfg.adaptive_rank`` too. A linear
    that holds ``w`` beside an adapter is compressed from its ``w`` and
    loses the adapter, as in the reference's walk. Each R is squared
    (``square_r``) where its projection is solved and dropped after, so no
    two square Rs are held at once (jamba's 64 expert ``hid`` streams alone
    are 57 GB squared at full width)."""
    r_factors = calibrator.thin_r_factors()
    if rank_map is None and ccfg.adaptive_rank:
        rank_map = adaptive_ranks(model, r_factors, ccfg.ratio)
    new_model = copy.deepcopy(model)
    reports: List[LayerReport] = []
    # the reference walk's order: prefix layers, then the reps; in a block
    # the mixer, then the FFN (an MoE layer before its shared experts)
    for p, mod in block_modules(new_model, (Linear, MoE)):
        if isinstance(mod, MoE):
            if any(k.startswith(p + "/expert") for k in r_factors):
                _compress_experts(mod, p, r_factors, ccfg, reports)
            continue
        lin = mod
        if not lin.has_dense or p not in r_factors:
            continue
        w = lin.w
        if not compressible(tuple(p.split("/")) + ("w",), w.shape):
            continue
        d_in, d_out = w.shape
        w_mat = w.T.float()                               # (d_out, d_in)
        if rank_map is not None and p in rank_map:
            rank = min(rank_map[p], min(d_in, d_out))
        else:
            rank = _rank(d_in, d_out, ccfg)
        r_f = square_r(r_factors[p]).float()
        a, b, mu = _solve(w_mat, r_f, rank, ccfg)
        num = torch.linalg.norm((w_mat - a @ b) @ r_f.T)
        den = torch.clamp(torch.linalg.norm(w_mat @ r_f.T), min=1e-9)
        bound = optimal_weighted_error(w_mat, r_f.T, rank) / den
        reports.append(LayerReport(
            path=p, rank=rank, mu=float(mu),
            rel_err_weighted=float(num / den),
            params_before=d_in * d_out,
            params_after=rank * (d_in + d_out),
            rel_err_bound=float(bound)))
        lin.set_factors(b.T.to(w.dtype), a.T.to(w.dtype))
    return new_model, reports


def rank_map_from_reports(reports) -> Dict[str, int]:
    """Per-layer ranks of a previous compression's reports, keyed by full
    calibrator path: recompressing with them keeps every factor's shape
    (what a live hot-swap of the factors needs). Per-expert rows (path
    suffix '/e<i>') are skipped, as in the JAX package."""
    return {r.path: r.rank for r in reports
            if not re.search(r"/e\d+$", r.path)}


def compress_model_pair(model, calibrator, ccfg: CompressConfig, *,
                        draft_ratio: float):
    """A speculative-decoding target at ``ccfg.ratio`` and a harder-
    compressed draft at ``draft_ratio`` from ONE calibration pass: both
    solves reuse the calibrator's R factors. Returns ``(target, draft,
    target_reports, draft_reports)``."""
    if not 0.0 < draft_ratio < 1.0:
        raise ValueError(f"draft_ratio must be in (0, 1), got {draft_ratio}")
    target, treports = compress_model(model, calibrator, ccfg)
    dcfg = dataclasses.replace(ccfg, ratio=draft_ratio, rank=0)
    draft, dreports = compress_model(model, calibrator, dcfg)
    return target, draft, treports, dreports


def compression_summary(reports) -> dict:
    before = sum(r.params_before for r in reports)
    after = sum(r.params_after for r in reports)
    errs = [r.rel_err_weighted for r in reports]
    return {"layers": len(reports),
            "params_before": before, "params_after": after,
            "kept_ratio": after / before if before else 1.0,
            "mean_rel_err": float(np.mean(np.asarray(errs, np.float32))) if errs else 0.0,
            "max_rel_err": float(np.max(np.asarray(errs, np.float32))) if errs else 0.0}
