"""Shared model building blocks: parallel context, norms (RMSNorm and olmo's
non-parametric LayerNorm), RoPE and qwen2-vl's M-RoPE, softcap,
activations, init, the recurrences' time loop (port of
``repro/models/common.py:11-36`` and ``:84-221``), the deterministic
scatter of padding rows and the layer rematerialization of training."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Runtime context threaded through the model's forward passes.

    Of the JAX package's fields the port reads five. ``use_pallas`` sends a
    causal full-sequence attention (no window, Tq == Tk) through
    ``kernels.ops.flash_attention``, which on a CUDA tensor launches the
    hand-written CUDA flash kernel (``csrc/flash_attention.cu``) where the
    JAX package runs its TPU Pallas kernel. Any other attention whose query
    or key length exceeds ``dense_attn_max_seq`` runs ``_chunked_sdpa``
    (``models/attention.py``) over ``attn_chunk_q`` x ``attn_chunk_kv``
    blocks instead of the dense einsum. ``mlstm_chunkwise`` runs an mLSTM
    over a sequence that is a whole number of chunks in the
    chunkwise-parallel form (``models/xlstm.py``), which gives the
    sequential recurrence's numbers in other rounding. The names and
    defaults are the JAX ones, so a parity test hands the same settings to
    both packages."""
    use_pallas: bool = False
    mlstm_chunkwise: bool = False
    dense_attn_max_seq: int = 2048
    attn_chunk_q: int = 2048
    attn_chunk_kv: int = 1024


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


def last_write_wins(keys: torch.Tensor, n_targets: int) -> torch.Tensor:
    """For an in-place scatter of N rows to targets ``keys`` (N,) ints in
    [0, ``n_targets``): the row whose value each row should carry — the
    last row, in row order, with the same target. Scattering
    ``src[last_write_wins(keys, n)]`` writes one value to each target, the
    one a sequential scatter leaves (the CPU's, and the reference's on the
    CPU); on the card a scatter with duplicate targets keeps whichever write
    lands last, which may differ between an eager call and a graph replay.
    Duplicates come from padding rows, which all write the trash page or the
    trash slot, and which an MoE's capacity selection can leave unequal.
    O(N + n_targets): a max-reduce of the row indices per target."""
    keys = keys.long()
    rows = torch.arange(keys.shape[0], device=keys.device)
    win = torch.full((n_targets,), -1, dtype=torch.long, device=keys.device)
    return win.scatter_reduce_(0, keys, rows, reduce="amax")[keys]


REMAT_MODES = ("none", "dots", "full")


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of products
    without a batch dimension (every projection, ``x @ w``, is an ``mm`` or
    ``addmm`` here), recompute the rest, the batched attention products
    (``bmm``) included."""
    policy = torch.utils.checkpoint.CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return policy.MUST_SAVE
    return policy.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _save_dots)


def rematerialize(fn, remat: str, *args):
    """``fn(*args)`` under the reference's ``jax.checkpoint`` of a scanned
    layer body (``repro/models/transformer.py:332-337``): ``none`` keeps
    every activation for the backward; ``full`` (``nothing_saveable``) keeps
    only ``args`` and recomputes the rest in the backward; ``dots`` keeps the
    outputs of the unbatched products as well. Without autograd it is a
    plain call. A recurrent mixer's own per-chunk checkpoint nests inside."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_MODES}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": _dots_context} if remat == "dots" else {}
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kw)


def chunked_scan(f, init, xs, chunk: int):
    """The reference's ``lax.scan`` over time with chunk-boundary
    checkpointing (``repro/models/common.py:189-221``), as a Python loop.

    ``f(carry, x_t) -> (carry, y_t)``; ``init`` a tuple of tensors; ``xs`` a
    tuple of tensors with the time axis first. Returns ``(carry, ys)``, the
    ``y_t`` stacked on a leading time axis. Without autograd it is a plain
    loop. Under autograd each run of ``chunk`` steps (a sequence shorter
    than a chunk is one run) goes through ``torch.utils.checkpoint``, so the
    backward keeps only the carries at the runs' boundaries and recomputes
    one run's steps at a time: an mLSTM's (B, H, hd, hd) matrix memory saved
    at every step of every layer would not fit on the card at full width.
    The numbers are those of the plain loop either way."""
    t = xs[0].shape[0]

    def run(carry, *xc):
        ys = []
        for i in range(xc[0].shape[0]):
            carry, y = f(carry, tuple(x[i] for x in xc))
            ys.append(y)
        return carry, torch.stack(ys)

    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in tuple(init) + tuple(xs))
    if not grad:
        return run(init, *xs)
    step = chunk if chunk > 0 else t
    carry, ys = init, []
    for lo in range(0, t, step):
        carry, y = torch.utils.checkpoint.checkpoint(
            run, carry, *(x[lo:lo + step] for x in xs), use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)
