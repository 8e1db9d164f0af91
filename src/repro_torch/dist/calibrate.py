"""Data-parallel Gram-free COALA calibration (port of
``repro/dist/calibrate.py``; paper §4.2, scaled out).

The calibration matrix ``X`` (features × tokens) of a production corpus
never fits on one device. Only the n×n ``R`` factor of ``Xᵀ`` is needed
(Prop. 2), and R factors compose by QR stacking. So calibration shards the
*token rows* over the ``data`` axis of a device mesh:

  1. every rank streams its own rows into per-layer local R factors
     (``core.calibrate.Calibrator``, the single-device TSQR streaming;
     X never exists);
  2. the local R factors reduce with the butterfly
     ``core.tsqr.distributed_tsqr_r``: log2(shards) exchange + QR rounds,
     after which every rank holds the same full R. No Gram matrix, no
     gather, O(n²) state per rank.

R is unique for full-rank input under the non-negative-diagonal sign
convention, so the combined R matches the single-device ``Calibrator``'s
for any shard count: entrywise within fp32 rounding where X is
well-conditioned, and in general up to a left-orthogonal factor under which
COALA's weighted projection (and RᵀR) is invariant. The Gram path squares
the condition number before it reduces; the QR path reduces factors that
are already orthogonalised, which is why ill-conditioned calibration
survives sharding here and not in the Gram-based baselines.

Every rank of the mesh's ``data`` axis calls ``calibrate_sharded`` on the
same batches and captures its own shard of each; where the reference runs
the shards as a host loop over fake devices, the port runs them as ranks
of a ``torch.distributed`` group (``dist/group.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

from repro_torch.core.calibrate import Calibrator
from repro_torch.core.tsqr import distributed_tsqr_r, qr_r, square_r, tsqr_tree
from repro_torch.models.common import CPU_CTX, ParallelCtx
from repro_torch.obs import trace


def split_batch(batch, n_shards: int) -> list:
    """Row-split a batch into ``n_shards`` equal sub-batches: a (B, T)
    token tensor, or a pipeline batch ``{"tokens", ...}`` whose every entry
    (a vlm's ``vision_embeds``, an encoder–decoder's ``frames``) splits
    with the tokens."""
    leaves = ([batch[k] for k in sorted(batch)] if isinstance(batch, dict)
              else [batch])
    b = leaves[0].shape[0]
    if b % n_shards:
        raise ValueError(f"batch rows {b} not divisible by {n_shards} shards")
    per = b // n_shards
    if isinstance(batch, dict):
        return [{k: v[s * per:(s + 1) * per] for k, v in batch.items()}
                for s in range(n_shards)]
    return [batch[s * per:(s + 1) * per] for s in range(n_shards)]


def _axis(mesh, axis: str):
    """(size, this rank's index, process group) of ``mesh``'s ``axis``."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.shape[dim], mesh.get_local_rank(axis), mesh.get_group(axis)


def combine_r_shards(r_local: torch.Tensor, mesh, axis: str = "data"
                     ) -> torch.Tensor:
    """Reduce this rank's R factor ``(n, n)`` with those of the other ranks
    on ``mesh``'s ``axis`` (a power of two) to the full R, the same on every
    rank: the butterfly TSQR over the axis' group. Every rank of the axis
    calls it."""
    size, _, group = _axis(mesh, axis)
    with trace.span("calib.butterfly_reduce", shards=size,
                    n=int(r_local.shape[-1])):
        if size == 1:
            return square_r(qr_r(r_local))
        return distributed_tsqr_r(r_local, group)


@dataclasses.dataclass
class ShardedCalibration:
    """Result of ``calibrate_sharded``: duck-types the ``Calibrator`` API
    that ``core.compress.compress_model`` and ``obs.numerics`` read.
    ``seconds`` holds this rank's ``capture`` and ``reduce`` wall times and
    ``bytes_sent`` what its butterfly rounds sent."""

    factors: Dict[str, torch.Tensor]
    tokens: Dict[str, int]
    n_shards: int
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_sent: int = 0

    def r_factors(self) -> Dict[str, torch.Tensor]:
        return dict(self.factors)

    def thin_r_factors(self) -> Dict[str, torch.Tensor]:
        """The factors ``compress_model`` reads; already square."""
        return dict(self.factors)

    def tokens_seen(self) -> Dict[str, int]:
        return dict(self.tokens)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_sharded(model, batches: Iterable, mesh, *, axis: str = "data",
                      ctx: ParallelCtx = CPU_CTX) -> ShardedCalibration:
    """Shard calibration rows over ``mesh``'s ``axis`` and butterfly-reduce
    the per-rank R factors; called on every rank of the axis with the same
    ``batches`` ((B, T) token tensors or pipeline batches, as
    ``calibrate_model`` takes them). Rank i of the axis captures shard i of
    every batch through ``model.capture_forward`` with ``ctx``. Returns the
    full R factors, the same on every rank, with the tokens summed over
    the ranks.

    Paths that only some ranks observed (MoE experts routed on a subset of
    the shards) are combined with the serial TSQR tree over the R factors
    of the ranks that saw them, in rank order: still Gram-free, off the
    butterfly. Every rank gathers those factors and computes the same tree.
    """
    n, me, group = _axis(mesh, axis)
    device = model.device
    cal = Calibrator()
    t0 = time.perf_counter()
    n_batches = 0
    for batch in batches:
        n_batches += 1
        sub = split_batch(batch, n)[me]
        if isinstance(sub, dict):
            extras = {k: v for k, v in sub.items() if k != "tokens"}
            model.capture_forward(sub["tokens"], cal, ctx=ctx, **extras)
        else:
            model.capture_forward(sub, cal, ctx=ctx)
    if n_batches == 0:
        raise ValueError("calibrate_sharded: no calibration batches")
    _sync(device)
    t1 = time.perf_counter()

    # every rank's paths, in its capture order, with their token counts
    seen: List[Dict[str, int]] = [None] * n
    dist.all_gather_object(seen, cal.tokens_seen(), group=group)
    all_paths: List[str] = []
    for rank_paths in seen:
        for p in rank_paths:
            if p not in all_paths:
                all_paths.append(p)
    partial = [p for p in all_paths if sum(p in s for s in seen) < n]
    gathered: List[Dict[str, torch.Tensor]] = [{}] * n
    if partial:                # per-expert MoE paths: every rank's factors
        gathered = [None] * n
        dist.all_gather_object(
            gathered, {p: square_r(cal.streams[p].r).cpu() for p in partial
                       if p in cal.streams}, group=group)

    factors: Dict[str, torch.Tensor] = {}
    tokens: Dict[str, int] = {}
    bytes_sent = 0
    rounds = int(math.log2(n))          # butterfly rounds (n a power of two)
    for path in all_paths:
        owners = [i for i in range(n) if path in seen[i]]
        tokens[path] = sum(seen[i][path] for i in owners)
        if len(owners) == n:
            r_local = square_r(cal.streams[path].r)
            factors[path] = combine_r_shards(r_local, mesh, axis=axis)
            bytes_sent += rounds * r_local.numel() * 4
        else:
            factors[path] = square_r(tsqr_tree(
                [gathered[i][path].to(device) for i in owners]))
    _sync(device)
    seconds = {"capture": t1 - t0, "reduce": time.perf_counter() - t1}
    return ShardedCalibration(factors=factors, tokens=tokens, n_shards=n,
                              seconds=seconds, bytes_sent=bytes_sent)
