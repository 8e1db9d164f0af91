"""Low-rank linear y = (x @ b_t) @ a_t: wrapper of ``csrc/lowrank_linear.cu``.

Port of ``repro/kernels/lowrank_linear.py``. A CPU tensor runs the plain
version (``ref.lowrank_linear_ref``); a CUDA tensor launches the CUDA kernel
(two tiled GEMMs, the intermediate cast to x's dtype in between) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lowrank_linear_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # calls that launched the CUDA kernel


def lowrank_linear(x, b_t, a_t):
    """x: (..., d_in); b_t: (d_in, r); a_t: (r, d_out) -> (..., d_out)."""
    if x.device.type == "cpu":
        return lowrank_linear_ref(x, b_t, a_t)
    if x.device.type != "cuda":
        raise ValueError(f"lowrank_linear: unsupported device {x.device}")
    return _launch(x, b_t, a_t)


def _launch(x, b_t, a_t):
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, b_t, a_t)):
        raise RuntimeError("lowrank_linear's CUDA kernel has no backward: call "
                           "it under torch.no_grad()")
    if b_t.ndim != 2 or a_t.ndim != 2:
        raise ValueError("lowrank_linear: b_t and a_t must be 2-D")
    d_in, r = b_t.shape
    r2, d_out = a_t.shape
    if x.shape[-1] != d_in or r2 != r:
        raise ValueError(f"lowrank_linear: shapes {tuple(x.shape)} @ "
                         f"{tuple(b_t.shape)} @ {tuple(a_t.shape)} do not chain")
    for name, t in (("x", x), ("b_t", b_t), ("a_t", a_t)):
        if t.device != x.device:
            raise ValueError(f"lowrank_linear: {name} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"lowrank_linear: {name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lowrank_linear: {name} must be contiguous")
    if x.dtype not in DTYPES:
        raise ValueError(f"lowrank_linear: unsupported dtype {x.dtype}")
    xm = x.reshape(-1, d_in)
    m = xm.shape[0]
    if m == 0:
        raise ValueError("lowrank_linear: empty input")
    lib = _build.lib()
    y = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    t = torch.empty((m, r), dtype=x.dtype, device=x.device)
    ws = int(lib.repro_lowrank_linear_workspace(m, d_in, r, d_out))
    work = torch.empty((max(ws, 1),), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_lowrank_linear(
            xm.data_ptr(), b_t.data_ptr(), a_t.data_ptr(), y.data_ptr(),
            t.data_ptr(), work.data_ptr(), m, d_in, r, d_out, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lowrank_linear")
    launches += 1
    return y.reshape(*x.shape[:-1], d_out)
