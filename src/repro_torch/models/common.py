"""Shared model building blocks: parallel context, norms (RMSNorm and olmo's
non-parametric LayerNorm), RoPE and qwen2-vl's M-RoPE, softcap,
activations, init (port of ``repro/models/common.py:11-36`` and
``:84-185``)."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Runtime context threaded through the model's forward passes.

    Of the JAX package's fields only ``use_pallas`` is read by the port: it
    sends a causal full-sequence attention (no window, Tq == Tk) through
    ``kernels.ops.flash_attention``, which on a CUDA tensor launches the
    hand-written CUDA flash kernel (``csrc/flash_attention.cu``) where the
    JAX package runs its TPU Pallas kernel. The name is the JAX one, so a
    parity test hands the same settings to both packages."""
    use_pallas: bool = False


CPU_CTX = ParallelCtx()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with the gemma-style ``(1 + scale)`` parametrization."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


class RMSNorm(torch.nn.Module):
    """Holds ``scale`` (zeros at init), applied as ``(1 + scale)``."""

    def __init__(self, d: int, eps: float, *, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(
            torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


def nonparametric_ln(x, eps: float = 1e-5):
    """OLMo-style LayerNorm without learnable scale/bias."""
    dt = x.dtype
    xf = x.float()
    c = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(c * c, dim=-1, keepdim=True)
    return (c * torch.rsqrt(var + eps)).to(dt)


class NonParametricLN(torch.nn.Module):
    """olmo's norm: no parameters at all (an empty dict in the JAX tree)."""

    def __init__(self, eps: float):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return nonparametric_ln(x, self.eps)


def make_norm(cfg, *, device=None, dtype=torch.float32) -> torch.nn.Module:
    if cfg.nonparametric_norm:
        return NonParametricLN(cfg.norm_eps)
    return RMSNorm(cfg.d_model, cfg.norm_eps, device=device, dtype=dtype)


def softcap(x, cap: float):
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., T) int -> cos/sin (..., T, head_dim//2)."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  sections):
    """Qwen2-VL M-RoPE (``repro/models/common.py:150-168``). position_ids:
    (3, B, T) ints for the (t, h, w) streams; ``sections`` split the
    head_dim // 2 frequency slots among them, in order. Returns cos/sin
    (B, T, head_dim // 2). With one position broadcast to all three streams
    it equals ``rope_cos_sin``."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    inv = rope_freqs(head_dim, theta, device=position_ids.device)
    ang = position_ids[..., None].float() * inv      # (3, B, T, half)
    splits, start = [], 0
    for i, sec in enumerate(sections):
        splits.append(ang[i, :, :, start:start + sec])
        start += sec
    ang_sel = torch.cat(splits, dim=-1)              # (B, T, half)
    return torch.cos(ang_sel), torch.sin(ang_sel)


def apply_rope(x, cos, sin):
    """x: (B, T, H, hd); cos/sin: (B, T, hd//2) or (T, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:                                # (T, half)
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:                                            # (B, T, half)
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    cos_, sin_ = cos_.to(x.dtype), sin_.to(x.dtype)
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def dense_init(w: torch.Tensor, generator: torch.Generator, scale: float = 1.0):
    """Fill a (d_in, d_out) weight in place with N(0, 1) * scale / sqrt(d_in)."""
    std = scale / math.sqrt(w.shape[0])
    with torch.no_grad():
        w.normal_(0.0, 1.0, generator=generator).mul_(std)
    return w


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation, so both names map to it
    gelu_tanh = lambda x: F.gelu(x, approximate="tanh")   # noqa: E731
    return {"silu": F.silu, "gelu": gelu_tanh, "gelu_tanh": gelu_tanh,
            "relu": F.relu}[name]
