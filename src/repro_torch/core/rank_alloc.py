"""Adaptive per-layer rank allocation (beyond-paper extension; port of
``repro/core/rank_alloc.py``).

The paper compresses every layer at the same ratio. Given the per-layer R
factors COALA already computes, the optimal rank split under a global
parameter budget has a closed greedy solution: the exact weighted-error
reduction of granting a layer one more rank is σ_{r+1}²(W Rᵀ) (Eckart–Young
on the weighted problem), at a parameter cost of (d_in + d_out).
Water-filling on the gain/cost ratio is optimal because singular values are
sorted, so marginal gains are non-increasing.

Every rep of the same layer position gets the SAME rank, as in the
reference, whose scanned layers restack into one tensor: those reps form
one allocation group. Granting the group +1 rank costs n_rep·(d_in+d_out)
and gains Σ_rep σ_{r+1,rep}². The calibrator's keys are the JAX paths
('blocks/2/sub0/mixer/wq'), so the port's unstacked reps fall into the
reference's groups unchanged.
"""
from __future__ import annotations

import heapq
import re
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.coala import svdvals

_STACK_RE = re.compile(r"^(blocks|enc|dec)/\d+/")


def default_group(path: str) -> str:
    """'blocks/3/sub0/mixer/wq' -> 'blocks/*/sub0/mixer/wq'."""
    return _STACK_RE.sub(lambda m: f"{m.group(1)}/*/", path)


def adaptive_rank_map(params_weights: Dict[str, torch.Tensor], r_factors,
                      ratio: float, *, min_rank: int = 1,
                      group_fn: Optional[Callable[[str], str]] = None
                      ) -> Dict[str, int]:
    """{path: rank} meeting budget = ratio × Σ dense params. ``params_weights``
    maps each path to its (d_in, d_out) weight, ``r_factors`` to its R."""
    group_fn = group_fn or default_group
    groups: Dict[str, list] = {}
    for p in params_weights:
        groups.setdefault(group_fn(p), []).append(p)

    gains: Dict[str, list] = {}           # per-group Σ_rep σ² (sorted desc)
    dims: Dict[str, Tuple[int, int, int]] = {}
    total_dense = 0
    for g, paths in groups.items():
        sq = None
        for p in paths:
            m = params_weights[p].T.float() @ r_factors[p].T.float()
            s2 = svdvals(m) ** 2
            sq = s2 if sq is None else sq + s2
        d_in, d_out = params_weights[paths[0]].shape
        dims[g] = (d_in, d_out, len(paths))
        gains[g] = sq.tolist()
        total_dense += d_in * d_out * len(paths)
    budget = int(ratio * total_dense)

    ranks: Dict[str, int] = {}
    heap = []
    spent = 0
    for g, sq in gains.items():
        d_in, d_out, n = dims[g]
        cost = (d_in + d_out) * n
        r0 = min(min_rank, len(sq))
        ranks[g] = r0
        spent += r0 * cost
        if r0 < min(len(sq), d_in, d_out):
            heapq.heappush(heap, (-sq[r0] / cost, g, r0))
    while heap:
        _, g, r = heapq.heappop(heap)
        if ranks[g] != r:
            continue                     # stale entry
        d_in, d_out, n = dims[g]
        cost = (d_in + d_out) * n
        if spent + cost > budget:
            continue                     # try cheaper groups
        ranks[g] = r + 1
        spent += cost
        sq = gains[g]
        if r + 1 < min(len(sq), d_in, d_out):
            heapq.heappush(heap, (-sq[r + 1] / cost, g, r + 1))

    return {p: ranks[group_fn(p)] for p in params_weights}
