"""Mamba (selective SSM), the mixer of jamba's hybrid stack (port of
``repro/models/ssm.py``).

Prefill runs the recurrence over time through ``chunked_scan`` (the
reference's ``lax.scan`` with chunk-boundary checkpointing); decode is one
step of the state update. The state is O(1) per request: the conv window
and the SSM state. The recurrence is XLA in the reference, not Pallas, so it
is plain PyTorch here on both devices; the projections are ``Linear``s, so a
compressed ``in_proj`` / ``out_proj`` runs the ``lowrank_linear`` kernel.

State. The mixer's ``cache`` is ``{"conv": (·, d_conv - 1, d_inner), "h":
(·, d_inner, d_state)}`` in fp32 whatever the serving cache's dtype (the
reference's ``_block_cache`` calls ``mamba_empty_cache`` without one), zeros
when empty. Without ``slots`` the leading axis is the batch
(``LM.init_contiguous_cache``); with ``slots`` (B,) the leaves are the block
pool's per-request slot stores, read with ``index_select`` and written back
with ``index_copy_`` into the same tensors, as xLSTM's (``models/xlstm.py``).

Calibration. The prefill scan multiplies by ``dt_proj``'s raw weight, as
the reference's does (``ssm.py:114-119`` there), so a calibrator's
forward pre-hook records ``in_proj``, ``x_proj`` and ``out_proj`` on a
prefill and never ``dt_proj``; only a decode step runs ``dt_proj`` as a
module.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import CPU_CTX, ParallelCtx, chunked_scan
from repro_torch.models.linear import Linear
from repro_torch.models.xlstm import read_state, write_state

SCAN_CHUNK = 64                  # the reference's chunked_scan chunk


def d_inner(cfg) -> int:
    return cfg.mamba.expand * cfg.d_model


def dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or math.ceil(cfg.d_model / 16)


def _causal_conv(x, conv_w, prepend):
    """Depthwise causal conv over time, summed tap by tap in the
    reference's order. x (B, T, di), conv_w (dc, di), prepend (B, dc-1, di).
    Returns (y, the last dc-1 rows of the padded input: the new window)."""
    t = x.shape[1]
    xp = torch.cat([prepend.to(x.dtype), x], dim=1)    # (B, T+dc-1, di)
    w = conv_w.to(x.dtype)
    out = xp[:, 0:t] * w[0]
    for i in range(1, conv_w.shape[0]):
        out = out + xp[:, i:i + t] * w[i]
    return out, xp[:, -(conv_w.shape[0] - 1):]


class Mamba(torch.nn.Module):
    """The Mamba mixer (``mamba_init`` / ``mamba_apply``): ``in_proj`` to
    (u, z), the causal depthwise conv ``conv_w`` and silu on u, ``x_proj``
    to (dt_in, B, C), dt = softplus(dt_in · ``dt_proj`` + ``dt_bias``), the
    selective scan h ← h·exp(dt·A) + dt·B·u with A = -exp(``a_log``), y =
    h·C + ``d_skip``·u, the silu(z) gate, then ``out_proj``. ``conv_w`` is in
    the model's dtype; ``dt_bias``, ``a_log`` and ``d_skip`` are fp32, and
    none of the four is a compression target."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.cfg = cfg
        d, di = cfg.d_model, d_inner(cfg)
        ds, dc, dtr = cfg.mamba.d_state, cfg.mamba.d_conv, dt_rank(cfg)
        self.in_proj = Linear(d, 2 * di, **kw)
        self.conv_w = torch.nn.Parameter(torch.zeros((dc, di), **kw))
        self.x_proj = Linear(di, dtr + 2 * ds, **kw)
        self.dt_proj = Linear(dtr, di, **kw)
        self.dt_bias = torch.nn.Parameter(torch.zeros((di,), **f32))
        self.a_log = torch.nn.Parameter(torch.zeros((di, ds), **f32))
        self.d_skip = torch.nn.Parameter(torch.ones((di,), **f32))
        self.out_proj = Linear(di, d, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The non-projection leaves as ``mamba_init`` draws them: ``conv_w``
        N(0, 1)/√d_conv (drawn in fp32), ``dt_bias`` the inverse softplus of
        a log-uniform dt in [1e-3, 1e-1] clipped at 1e-4, ``a_log`` log(1 ..
        d_state) on every row, ``d_skip`` 1."""
        dc, di = self.conv_w.shape
        ds = self.a_log.shape[1]
        dev = self.conv_w.device
        conv = torch.randn((dc, di), generator=generator, device=dev)
        self.conv_w.copy_(conv / math.sqrt(dc))
        u = torch.rand((di,), generator=generator, device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        self.dt_bias.copy_(torch.log(torch.expm1(torch.clamp(dt, min=1e-4))))
        self.a_log.copy_(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=dev)).expand(di, ds))
        self.d_skip.fill_(1.0)

    def state_shapes(self):
        """Per-request state leaves (without the leading axis)."""
        dc, di = self.conv_w.shape
        return {"conv": (dc - 1, di), "h": (di, self.a_log.shape[1])}

    def forward(self, x, *, cache: Optional[dict] = None, slots=None,
                pos=None, ctx: ParallelCtx = CPU_CTX):
        """x (B, T, d_model) -> (B, T, d_model). One token with a cache and
        a position is a decode step; anything else is a prefill from the
        cache's state (None: from zeros, none kept), which leaves the final
        state in the cache."""
        cfg = self.cfg
        b, t, _ = x.shape
        ds, dtr = cfg.mamba.d_state, dt_rank(cfg)
        u, z = torch.chunk(self.in_proj(x), 2, dim=-1)   # (B, T, di)
        a = -torch.exp(self.a_log)                       # (di, ds)
        shapes = self.state_shapes()
        conv0, h0 = read_state(cache, slots, shapes, b, x.device)
        if cache is not None and pos is not None and t == 1:
            conv_win = torch.cat([conv0.to(u.dtype), u], dim=1)  # (B, dc, di)
            u_c = F.silu(torch.einsum("bci,ci->bi", conv_win,
                                      self.conv_w.to(u.dtype)))[:, None, :]
            dt_in, bb, cc = torch.split(self.x_proj(u_c), [dtr, ds, ds],
                                        dim=-1)
            dt = F.softplus(self.dt_proj(dt_in).float() + self.dt_bias)
            bb, cc = bb.float(), cc.float()
            da = torch.exp(dt[:, 0, :, None] * a[None])  # (B, di, ds)
            h = h0 * da + dt[:, 0, :, None] * bb[:, 0, None, :] * \
                u_c[:, 0, :, None].float()
            y = torch.einsum("bis,bs->bi", h, cc[:, 0]) + \
                self.d_skip * u_c[:, 0].float()
            y = y[:, None, :].to(x.dtype)
            write_state(cache, slots, shapes, (conv_win[:, 1:], h))
        else:
            u_conv, conv_win = _causal_conv(u, self.conv_w, conv0)
            u_c = F.silu(u_conv)                          # (B, T, di)
            dt_in, bb, cc = torch.split(self.x_proj(u_c), [dtr, ds, ds],
                                        dim=-1)
            dt_w = self.dt_proj.w

            def dt_of(dtin):
                # dt_proj's raw weight, not its module (see the docstring)
                return F.softplus((dtin @ dt_w.to(dtin.dtype)).float()
                                  + self.dt_bias)
            # under autograd dt is computed inside the checkpointed scan, so
            # backward recomputes its fp32 (B, T, d_inner) values instead of
            # keeping them (the reference's choice); without autograd nothing
            # is kept, and one product over all T steps takes the place of T
            inside = torch.is_grad_enabled()
            dts = dt_in if inside else dt_of(dt_in)

            def step(carry, inp):
                u_t, d_t, bb_t, cc_t = inp
                dt_t = dt_of(d_t) if inside else d_t      # (B, di)
                da_t = torch.exp(dt_t[..., None] * a[None])
                h = carry[0] * da_t + dt_t[..., None] * \
                    bb_t[:, None, :].float() * u_t[..., None].float()
                return (h,), torch.einsum("bis,bs->bi", h, cc_t.float())

            (h_last,), ys = chunked_scan(
                step, (h0,),
                tuple(v.movedim(1, 0) for v in (u_c, dts, bb, cc)),
                SCAN_CHUNK)
            y = ys.movedim(0, 1) + self.d_skip * u_c.float()
            y = y.to(x.dtype)
            write_state(cache, slots, shapes, (conv_win, h_last))
        return self.out_proj(y * F.silu(z))
