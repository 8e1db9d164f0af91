"""FFN family: the gated MLP and the mixture of experts (port of
``repro/models/ffn.py:30-50``, ``:52-110`` and ``:113-156``, ``:199-208``).

The MoE layer routes each token to its ``top_k`` experts (fp32 router,
softmax, renormalised top-k gates, switch-style load-balance aux loss),
then each expert takes the ``capacity`` tokens of highest gate (drop
policy; the capacity comes from the padded token count, so it is static
for a step signature). The routed experts' GLU runs as batched matmuls over
the expert banks, outside any kernel, as the reference runs them under
``vmap``; the shared experts are an ordinary ``MLP`` whose projections go
through ``lowrank_linear`` once factored. The reference's expert-parallel
``shard_map`` branch waits for the distributed slice.

Both top-k selections break ties toward the lower index, as
``jax.lax.top_k`` does (a stable descending sort), and the combine adds each
token's expert outputs in expert order into per-token slots with no atomic
adds, so a step gives the same bits every time, in CUDA graphs too.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.models.common import act_fn
from repro_torch.models.linear import Linear


class MLP(torch.nn.Module):
    """down(act(gate(x)) * up(x)), or with ``glu=False`` (whisper's MLP,
    which has no ``gate``) down(act(up(x)))."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, glu: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)
        self.gate = Linear(d_model, d_ff, **kw) if glu else None
        self.act = act_fn(act)

    def forward(self, x):
        if self.gate is None:
            return self.down(self.act(self.up(x)))
        return self.down(self.act(self.gate(x)) * self.up(x))


class ExpertBank(torch.nn.Module):
    """E stacked projections: dense ``w`` (E, d_in, d_out) or the factored
    pair ``b_t`` (E, d_in, r), ``a_t`` (E, r, d_out) — the reference's tuple
    ``(b_t, a_t)`` after per-expert compression."""

    def __init__(self, n_experts: int, d_in: int, d_out: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(
            torch.zeros((n_experts, d_in, d_out), device=device, dtype=dtype))

    @property
    def is_factored(self) -> bool:
        return "b_t" in self._parameters

    def set_dense(self, w: torch.Tensor) -> None:
        for name in ("b_t", "a_t"):
            self._parameters.pop(name, None)
        self.w = torch.nn.Parameter(w)

    def set_factors(self, b_t: torch.Tensor, a_t: torch.Tensor) -> None:
        self._parameters.pop("w", None)
        self.b_t = torch.nn.Parameter(b_t.contiguous())
        self.a_t = torch.nn.Parameter(a_t.contiguous())

    def forward(self, x):
        """x (E, C, d_in) -> (E, C, d_out), expert e on row block e."""
        if self.is_factored:
            return torch.bmm(torch.bmm(x, self.b_t.to(x.dtype)),
                             self.a_t.to(x.dtype))
        return torch.bmm(x, self.w.to(x.dtype))


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and their
    indices, ties to the lower index (a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def capacity(n_tokens: int, cfg) -> int:
    """Tokens each expert takes from a call of ``n_tokens`` (padding rows
    included, as in the reference)."""
    m = cfg.moe
    cap = max(m.min_capacity,
              int(math.ceil(m.top_k * n_tokens / m.num_experts
                            * m.capacity_factor)))
    return min(cap, n_tokens)


def route(x_flat, router_w, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token expert weights gw (N, E) — the renormalised top-k softmax
    gates, 0 elsewhere — and the switch load-balance aux (unweighted)."""
    m = cfg.moe
    probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
    top_p, top_i = top_k(probs, m.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    gw = torch.zeros_like(probs).scatter(1, top_i, top_p)
    frac = torch.mean((gw > 0).float(), dim=0)            # f_e
    imp = torch.mean(probs, dim=0)                        # P_e
    return gw, m.num_experts * torch.sum(frac * imp)


def combine(y_e, idx, w_sel, n: int, k: int):
    """out[t] = Σ_e y_e[e, c] over the (e, c) with idx[e, c] == t and
    w_sel[e, c] > 0, added in expert order. Each such token has at most k
    experts: its outputs are copied into k per-token slots (the others into
    rows of their own past the slots), then the slots are summed in order —
    no atomics, so the result repeats bit for bit. Entries of zero weight
    add ±0 in the reference and are left out here."""
    e_count, c, d = y_e.shape
    sel = w_sel > 0
    hit = torch.zeros((e_count, n), dtype=torch.int32, device=y_e.device)
    hit.scatter_(1, idx, sel.to(torch.int32))
    slot = torch.cumsum(hit, dim=0) - 1                   # (E, n)
    dst = idx * k + torch.gather(slot, 1, idx)
    spare = n * k + torch.arange(e_count * c, device=y_e.device).view(e_count, c)
    dst = torch.where(sel, dst, spare)
    buf = torch.zeros((n * k + e_count * c, d), dtype=y_e.dtype,
                      device=y_e.device)
    buf.index_copy_(0, dst.reshape(-1), y_e.reshape(-1, d))
    slots = buf[:n * k].view(n, k, d)
    out = slots[:, 0]
    for j in range(1, k):
        out = out + slots[:, j]
    return out


class MoE(torch.nn.Module):
    """Token-choice top-k MoE with per-expert capacity, plus shared experts.

    ``expert_sink`` is the layer's calibration hook point: while set (by
    ``core/calibrate.py``'s capture) the forward hands it, per expert, the
    inputs of the tokens it took with a non-zero gate (``expert{e}/in``) and
    their GLU hidden states (``expert{e}/hid``)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.router = torch.nn.Parameter(                 # fp32 router
            torch.zeros((d, e), device=device, dtype=torch.float32))
        self.w_gate = ExpertBank(e, d, f, **kw)
        self.w_up = ExpertBank(e, d, f, **kw)
        self.w_down = ExpertBank(e, f, d, **kw)
        if m.num_shared > 0:
            self.shared = MLP(d, m.num_shared * f, cfg.act, **kw)
        self.act = act_fn(cfg.act)
        self.expert_sink: Optional[Callable[[str, torch.Tensor], None]] = None

    def forward(self, x):
        """x (B, T, d) -> (y, aux loss × aux_loss_weight)."""
        cfg = self.cfg
        b, t, d = x.shape
        n = b * t
        x_flat = x.reshape(n, d)
        gw, aux = route(x_flat, self.router, cfg)
        w_sel, idx = top_k(gw.T, capacity(n, cfg))        # (E, C)
        x_e = x_flat[idx.reshape(-1)].reshape(idx.shape[0], idx.shape[1], d)
        h = self.act(self.w_gate(x_e)) * self.w_up(x_e)
        if self.expert_sink is not None:
            self._record(x_e, h, w_sel)
        y_e = self.w_down(h) * w_sel[..., None].to(x.dtype)
        y = combine(y_e, idx, w_sel, n, cfg.moe.top_k).reshape(b, t, d)
        if cfg.moe.num_shared > 0:
            y = y + self.shared(x)
        return y, aux * cfg.moe.aux_loss_weight

    def _record(self, x_e, h, w_sel) -> None:
        """Eager calibration capture (``repro/models/ffn.py:126-142``)."""
        for e in range(x_e.shape[0]):
            used = w_sel[e] > 0
            if used.any():
                self.expert_sink(f"expert{e}/in", x_e[e][used])
                self.expert_sink(f"expert{e}/hid", h[e][used])
