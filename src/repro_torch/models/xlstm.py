"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (port of
``repro/models/xlstm.py``).

mLSTM is the matrix-memory cell with exponential gating and max-state
stabilization, run step by step (``_mlstm_cell`` through ``chunked_scan``)
or, under ``ParallelCtx.mlstm_chunkwise`` on a sequence that is a whole
number of chunks, in the chunkwise-parallel form (``_mlstm_chunkwise``);
sLSTM is the recurrent scalar-memory cell whose hidden state feeds back
through block-diagonal per-head matrices ``r_*``. Both keep O(1) state per
request whatever the context length. The recurrences are XLA in the
reference, not Pallas, so they are plain PyTorch here on both devices; their
projections are ``Linear``s, so a compressed one runs the ``lowrank_linear``
kernel.

State. A mixer's ``cache`` is a dict of fp32 state leaves, whatever the
serving cache's dtype (the reference's ``_block_cache`` passes none):
mLSTM ``{"c": (·, H, hd, hd), "n": (·, H, hd), "m": (·, H)}``, sLSTM
``{"c", "n", "h", "m"}`` each (·, d_model); ``m`` starts at -1e30. Without
``slots`` the leading axis is the batch (``LM.init_contiguous_cache``) and
the final state is written back in place. With ``slots`` (B,) the leaves are
the block pool's per-request slot stores: the rows are gathered before the
recurrence (``index_select``) and scattered after it (``index_copy_``) into
the same store tensors — the reference's ``_gather_state`` /
``_scatter_state``, which return new arrays, in place, because a captured
CUDA graph holds the stores' addresses. Batch-padding rows point at the
pool's trash slot; their garbage stays in their own rows (nothing here
reduces across rows).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (CPU_CTX, ParallelCtx, act_fn,
                                       chunked_scan, last_write_wins)
from repro_torch.models.linear import Linear

_M0 = -1e30                      # the stabilizer state before any token


def _mlstm_dims(cfg):
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    h = cfg.n_heads
    return di, h, di // h


def empty_state(shapes, lead: Tuple[int, ...], device) -> dict:
    """Zero state leaves with leading dims ``lead``, ``m`` at -1e30 (the
    reference's ``mlstm_empty_cache`` / ``slstm_empty_cache``), fp32."""
    return {k: torch.full(lead + s, _M0 if k == "m" else 0.0,
                          dtype=torch.float32, device=device)
            for k, s in shapes.items()}


def read_state(cache, slots, shapes: dict, batch: int, device):
    """The fp32 state of the batch's rows, leaves in ``shapes``' order: the
    empty state without a cache, the rows of a contiguous cache, or the
    slots' rows of the slot stores."""
    if cache is None:
        return tuple(empty_state(shapes, (batch,), device).values())
    if slots is None:
        return tuple(cache[k].float() for k in shapes)
    return tuple(cache[k].index_select(0, slots).float() for k in shapes)


def write_state(cache, slots, shapes: dict, state) -> None:
    """The final state into the contiguous cache's rows or the slots' rows
    of the slot stores, in place, in the stores' dtype; padding rows, which
    share the trash slot, all write the last one's state
    (``last_write_wins``)."""
    if cache is None:
        return
    for k, s in zip(shapes, state):
        if slots is None:
            cache[k].copy_(s)
        else:
            last = last_write_wins(slots, cache[k].shape[0])
            cache[k].index_copy_(0, slots, s.to(cache[k].dtype)[last])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_cell(c, n, m, q, k, v, log_i, log_f):
    """One recurrent step. q/k/v: (B, H, hd); log gates (B, H)."""
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)                       # (B, H)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s[..., None, None] * c + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])               # (B, H, hd_k, hd_v)
    n_new = f_s[..., None] * n + i_s[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)),
                          torch.exp(-m_new))
    y = torch.einsum("bhkv,bhk->bhv", c_new, q) / denom[..., None]
    return c_new, n_new, m_new, y


def _mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk: int):
    """Chunkwise-parallel mLSTM (``repro/models/xlstm.py:69-121``): each
    chunk of L tokens is two (L x L) / (L x hd) products against the state,
    which is read and written once a chunk, with the sequential cell's
    stabilization (m_t = max(a_t + m_0, cummax_s(li_s - a_s) + a_t)).
    q, k, v: (B, T, H, hd) fp32 (q and k pre-scaled); log gates (B, T, H);
    T a multiple of ``chunk``. Returns (y (B, T, H, hd), final state)."""
    t = q.shape[1]
    c_st, n_st, m_st = state                   # (B,H,K,V) (B,H,K) (B,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    ys = []
    for lo in range(0, t, chunk):
        qc, kc, vc, lic, lfc = (x[:, lo:lo + chunk]
                                for x in (q, k, v, log_i, log_f))
        a = torch.cumsum(lfc, dim=1)           # (B, L, H) inclusive decay
        a_tot = a[:, -1]                       # (B, H)
        cmax = torch.cummax(lic - a, dim=1).values
        m_t = torch.maximum(a + m_st[:, None, :], cmax + a)      # (B, L, H)
        scale_in = torch.exp(a + m_st[:, None, :] - m_t)
        h_inter = torch.einsum("blhk,bhkv->blhv", qc, c_st) * scale_in[..., None]
        qn_inter = torch.einsum("blhk,bhk->blh", qc, n_st) * scale_in
        # intra-chunk: D_{t,s} = exp(li_s - a_s + a_t - m_t), s <= t
        logd = ((lic - a)[:, None, :, :] + a[:, :, None, :]
                - m_t[:, :, None, :])          # (B, Lt, Ls, H)
        d = torch.where(tri[None, :, :, None], torch.exp(logd), 0.0)
        s_mat = torch.einsum("bthk,bshk->btsh", qc, kc) * d
        h_intra = torch.einsum("btsh,bshv->bthv", s_mat, vc)
        qn = qn_inter + torch.sum(s_mat, dim=2)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
        ys.append((h_inter + h_intra) / denom[..., None])
        # state to the chunk's end
        m_next = torch.maximum(a_tot + m_st, cmax[:, -1] + a_tot)
        carry_scale = torch.exp(a_tot + m_st - m_next)
        w_out = torch.exp(lic - a + a_tot[:, None, :] - m_next[:, None, :])
        kw = kc * w_out[..., None]
        c_st = carry_scale[..., None, None] * c_st + torch.einsum(
            "bshk,bshv->bhkv", kw, vc)
        n_st = carry_scale[..., None] * n_st + torch.sum(kw, dim=1)
        m_st = m_next
    return torch.cat(ys, dim=1), (c_st, n_st, m_st)


class MLSTM(torch.nn.Module):
    """The mLSTM mixer (``mlstm_init`` / ``mlstm_apply``): ``up`` to
    (u, z), q/k/v from u, scalar input and forget gates per head from u
    (``w_i``, ``w_f``, ``f_bias``; fp32 whatever the model's dtype), the
    matrix-memory recurrence, ``o_norm_scale`` and the silu(z) gate, then
    ``down``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.cfg = cfg
        d = cfg.d_model
        di, h, _ = _mlstm_dims(cfg)
        self.up = Linear(d, 2 * di, **kw)
        self.wq = Linear(di, di, **kw)
        self.wk = Linear(di, di, **kw)
        self.wv = Linear(di, di, **kw)
        self.w_i = torch.nn.Parameter(torch.zeros((di, h), **f32))
        self.w_f = torch.nn.Parameter(torch.zeros((di, h), **f32))
        self.f_bias = torch.nn.Parameter(torch.full((h,), 3.0, **f32))
        self.o_norm_scale = torch.nn.Parameter(torch.ones((di,), **f32))
        self.down = Linear(di, d, **kw)

    def state_shapes(self):
        """Per-request state leaves (without the leading axis)."""
        _, h, hd = _mlstm_dims(self.cfg)
        return {"c": (h, hd, hd), "n": (h, hd), "m": (h,)}

    def forward(self, x, *, cache: Optional[dict] = None, slots=None,
                pos=None, ctx: ParallelCtx = CPU_CTX):
        """x (B, T, d_model) -> (B, T, d_model); ``cache``/``slots`` as in
        the module docstring (None: from the empty state, none kept).
        ``pos`` is not read: the recurrence is the same at any position."""
        cfg = self.cfg
        b, t, _ = x.shape
        di, h, hd = _mlstm_dims(cfg)
        u, z = torch.chunk(self.up(x), 2, dim=-1)        # (B, T, di)
        q = self.wq(u).reshape(b, t, h, hd) / math.sqrt(hd)
        k = self.wk(u).reshape(b, t, h, hd) / math.sqrt(hd)
        v = self.wv(u).reshape(b, t, h, hd)
        uf = u.float()
        # the gate vectors in fp32 (bf16 under a bf16 training step's cast),
        # as the reference's fp32 @ w_i promotes them
        log_i = uf @ self.w_i.float()                     # (B, T, H)
        log_f = F.logsigmoid(uf @ self.w_f.float() + self.f_bias)
        shapes = self.state_shapes()                      # c, n, m
        state = read_state(cache, slots, shapes, b, x.device)
        qf, kf, vf = (a.float() for a in (q, k, v))
        chunk = cfg.xlstm.chunk_size
        if ctx.mlstm_chunkwise and t > 1 and t % chunk == 0:
            y4, state = _mlstm_chunkwise(qf, kf, vf, log_i, log_f, state,
                                         chunk)
        else:
            def step(carry, inp):
                c, n, m = carry
                c, n, m, y_t = _mlstm_cell(c, n, m, *inp)
                return (c, n, m), y_t

            state, ys = chunked_scan(
                step, state, tuple(a.movedim(1, 0) for a in
                                   (qf, kf, vf, log_i, log_f)), chunk)
            y4 = ys.movedim(0, 1)
        write_state(cache, slots, shapes, state)
        y = y4.reshape(b, t, di).to(x.dtype)
        # group-norm-ish output scaling, gate, down-projection
        y = y * self.o_norm_scale.to(y.dtype)
        y = y * F.silu(z)
        return self.down(y)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(torch.nn.Module):
    """The sLSTM mixer (``slstm_init`` / ``slstm_apply``): four gate
    projections ``w_{i,f,z,o}`` of x, each plus a block-diagonal recurrence
    of the previous hidden state through ``r_{i,f,z,o}`` (H, hd, hd), the
    scalar-memory cell with exponential gating, then a gated feed-forward
    (GLU of width int(4/3 d_model), tanh gelu) through ``ff_up`` /
    ``ff_down``. The ``r_*`` are bare tensors in the model's dtype and
    ``f_bias`` is fp32; neither is a compression target."""

    GATES = ("i", "f", "z", "o")

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        for g in self.GATES:
            setattr(self, f"w_{g}", Linear(d, d, **kw))
        for g in self.GATES:
            setattr(self, f"r_{g}", torch.nn.Parameter(
                torch.zeros((h, hd, hd), **kw)))
        self.f_bias = torch.nn.Parameter(
            torch.full((d,), 3.0, device=device, dtype=torch.float32))
        ff = int(4 / 3 * d)
        self.ff_up = Linear(d, 2 * ff, **kw)
        self.ff_down = Linear(ff, d, **kw)

    def state_shapes(self):
        """Per-request state leaves (without the leading axis)."""
        d = self.cfg.d_model
        return {"c": (d,), "n": (d,), "h": (d,), "m": (d,)}

    def forward(self, x, *, cache: Optional[dict] = None, slots=None,
                pos=None, ctx: ParallelCtx = CPU_CTX):
        b, t, d = x.shape
        heads = self.cfg.n_heads
        hd = d // heads
        pre = {g: getattr(self, f"w_{g}")(x).float() for g in self.GATES}
        pre["f"] = pre["f"] + self.f_bias
        r = {g: getattr(self, f"r_{g}").float() for g in self.GATES}

        def rec(h_prev, g):                          # (B, d) @ blockdiag R
            hh = h_prev.reshape(h_prev.shape[0], heads, hd)
            return torch.einsum("bhk,hkv->bhv", hh, r[g]).reshape(-1, d)

        def step(carry, inp):
            c, n, h_prev, m = carry
            pi, pf, pz, po = inp
            li = pi + rec(h_prev, "i")
            lf = F.logsigmoid(pf + rec(h_prev, "f"))
            z = torch.tanh(pz + rec(h_prev, "z"))
            o = torch.sigmoid(po + rec(h_prev, "o"))
            m_new = torch.maximum(lf + m, li)
            i_s = torch.exp(li - m_new)
            f_s = torch.exp(lf + m - m_new)
            c_new = f_s * c + i_s * z
            n_new = f_s * n + i_s
            h_new = o * c_new / torch.clamp(n_new, min=1e-6)
            return (c_new, n_new, h_new, m_new), h_new

        shapes = self.state_shapes()                      # c, n, h, m
        state = read_state(cache, slots, shapes, b, x.device)
        state, hs = chunked_scan(
            step, state, tuple(pre[g].movedim(1, 0) for g in self.GATES),
            self.cfg.xlstm.chunk_size)
        write_state(cache, slots, shapes, state)
        y = hs.movedim(0, 1).to(x.dtype)                 # (B, T, d)
        # gated feed-forward (proj factor 4/3, GLU)
        a, g = torch.chunk(self.ff_up(y), 2, dim=-1)
        return self.ff_down(act_fn("gelu")(a) * g)
