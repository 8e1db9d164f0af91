"""PyTorch/CUDA port of the COALA repro package (``src/repro``).

The port mirrors ``src/repro`` file by file and is held against it by parity
tests. It imports torch and numpy only, never jax and nothing of ``repro``.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
without a GPU it raises unless the caller asks for ``"cpu"``. Kernels
dispatch on the device of the tensors they are given: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the hand-written CUDA kernel
(or raises). Nothing falls back to the CPU by itself.
"""
from __future__ import annotations

import torch

# COALA's numerical story (QR-based weighting, SVD of W Rᵀ, μ from Eq. 5)
# and the parity tests against the fp32 reference assume full float32
# products. TF32 keeps ~3 decimal digits; PyTorch already defaults matmuls
# to full fp32, but cuDNN does not, so both are pinned off here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` needs a visible GPU and
    raises without one (no silent move to the CPU). ``"meta"`` builds
    shapes without storage (the sharding plans of a full-width model)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
