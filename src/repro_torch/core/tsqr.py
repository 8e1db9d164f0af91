"""TSQR: R factors of calibration matrices that never fit in memory (port of
``repro/core/tsqr.py``).

Only the R factor of the QR of ``Xᵀ`` (rows = tokens) is needed downstream
(the paper's Prop. 2). ``RStreamer`` folds activation chunks into a running
R with the ``[R; chunk] -> QR`` recurrence (``tsqr_sequential``), so X is
never formed; ``tsqr_tree`` combines chunk Rs pairwise (the paper's
multi-GPU tree). R is returned with a non-negative diagonal so it is unique
and comparable. ``gram_chunked`` is the Gram path the paper compares
against. ``distributed_tsqr_r`` is the tree across ranks: a butterfly
(XOR pairing) over a ``torch.distributed`` group, after which every rank
holds the same full R.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist


def _fix_sign(r: torch.Tensor) -> torch.Tensor:
    """Flip row signs so diag(R) >= 0 (makes R unique for full-rank input)."""
    d = torch.diagonal(r)
    s = torch.where(d < 0, -1.0, 1.0).to(r.dtype)
    return r * s[:, None]


def qr_r(xt: torch.Tensor, fix_sign: bool = True) -> torch.Tensor:
    """R factor of the reduced QR of ``xt`` (rows = tokens, cols = n)."""
    r = torch.linalg.qr(xt, mode="r").R
    return _fix_sign(r) if fix_sign else r


def stack_qr(r_top: torch.Tensor, r_bot: torch.Tensor) -> torch.Tensor:
    """R factor of qr([R_top; R_bot]) — the TSQR combine step."""
    return qr_r(torch.cat([r_top, r_bot], dim=0))


def tsqr_sequential(chunks: Iterable[torch.Tensor]) -> torch.Tensor:
    """Streaming TSQR: fold token-chunks (each (k_i, n) rows of Xᵀ)."""
    r: Optional[torch.Tensor] = None
    for c in chunks:
        if c.ndim != 2:
            raise ValueError(f"chunk must be 2-D (tokens, features), got {tuple(c.shape)}")
        r = qr_r(c) if r is None else stack_qr(r, c)
    if r is None:
        raise ValueError("tsqr_sequential: no chunks")
    return r


def tsqr_tree(chunks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Binary-tree TSQR (paper Fig. in §4.2): pairwise combine until one R."""
    rs = [qr_r(c) for c in chunks]
    while len(rs) > 1:
        nxt = [stack_qr(rs[i], rs[i + 1]) for i in range(0, len(rs) - 1, 2)]
        if len(rs) % 2 == 1:
            nxt.append(rs[-1])
        rs = nxt
    return rs[0]


class RStreamer:
    """Streaming R accumulator of the calibration pipeline: ``update``
    consumes a (tokens, n) activation chunk, ``finish`` returns the final
    square R (optionally μ-augmented, Prop. 3)."""

    def __init__(self, n: int, dtype=torch.float32):
        self.n = n
        self.dtype = dtype
        self._r: Optional[torch.Tensor] = None
        self.tokens_seen = 0

    def update(self, chunk: torch.Tensor) -> None:
        chunk = chunk.reshape(-1, self.n).to(self.dtype)
        self.tokens_seen += int(chunk.shape[0])
        self._r = qr_r(chunk) if self._r is None else stack_qr(self._r, chunk)

    @property
    def r(self) -> torch.Tensor:
        if self._r is None:
            raise ValueError("RStreamer: no data seen")
        return self._r

    def finish(self, mu: float = 0.0) -> torch.Tensor:
        r = self.r
        if mu > 0.0:
            r = augment_r_with_mu(r, mu)
        return square_r(r)


def square_r(r: torch.Tensor) -> torch.Tensor:
    """Pad/keep R to a square (n, n) upper-triangular matrix."""
    k, n = r.shape
    if k == n:
        return r
    if k > n:
        return qr_r(r)
    out = torch.zeros((n, n), dtype=r.dtype, device=r.device)
    out[:k] = r
    return out


def augment_r_with_mu(r: torch.Tensor, mu: float) -> torch.Tensor:
    """R of the μ-augmented matrix X̃ = [X  √μ·I] (Prop. 3): qr([R; √μ I])."""
    n = r.shape[-1]
    eye = torch.sqrt(torch.tensor(mu, dtype=r.dtype)).item() * torch.eye(
        n, dtype=r.dtype, device=r.device)
    return stack_qr(square_r(r), eye)


def distributed_tsqr_r(xt_local: torch.Tensor, group=None) -> torch.Tensor:
    """Butterfly TSQR over the ranks of ``group`` (the default group when
    None); every rank of the group calls it. ``xt_local``: this rank's
    (k_local, n) rows of Xᵀ. Returns the full (n, n) R, the same on every
    rank.

    log2(size) rounds: each pairs rank ``me`` with ``me ^ (1 << s)``, the
    two swap their R (contiguous fp32 host copies through
    ``batch_isend_irecv``, so a gloo group carries it whatever the device)
    and both factor [R_lower; R_upper], the lower rank's on top, on their
    own device, so both sides compute the same R."""
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    r = square_r(qr_r(xt_local))   # (n, n) so every round swaps one shape
    rounds = int(math.log2(size))
    if 2 ** rounds != size:
        raise ValueError(f"axis size {size} must be a power of two for butterfly TSQR")
    for s in range(rounds):
        partner = me ^ (1 << s)
        peer = partner if group is None else dist.get_global_rank(group, partner)
        mine = r.detach().to("cpu", torch.float32).contiguous()
        other = torch.empty_like(mine)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, mine, peer, group),
                dist.P2POp(dist.irecv, other, peer, group)]):
            req.wait()
        other = other.to(device=r.device, dtype=r.dtype)
        r = qr_r(torch.cat([r, other] if me < partner else [other, r], dim=0))
    return r


def gram_chunked(chunks: Iterable[torch.Tensor]) -> torch.Tensor:
    """Baseline Gram accumulation  XXᵀ = Σ XᵢXᵢᵀ  (the numerically risky path
    the paper compares against). Each chunk is (tokens, n) rows of Xᵀ."""
    g: Optional[torch.Tensor] = None
    for c in chunks:
        contrib = c.T @ c
        g = contrib if g is None else g + contrib
    if g is None:
        raise ValueError("gram_chunked: no chunks")
    return g
