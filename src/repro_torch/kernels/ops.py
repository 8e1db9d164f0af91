"""Public kernel entry points of the port (counterpart of ``repro/kernels/ops.py``).

Dispatch goes by the device of the tensors, which the caller chose: a CPU
tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written CUDA kernel (built from ``repro_torch/csrc`` at first use) or
raises. There is no automatic fallback.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import chunked_prefill as _cp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram_accum as _ga
from repro_torch.kernels import lowrank_linear as _ll
from repro_torch.kernels import paged_attention as _pa

lowrank_linear = _ll.lowrank_linear
paged_attention = _pa.paged_attention
chunked_prefill = _cp.chunked_prefill
flash_attention = _fa.flash_attention
gram_accum = _ga.gram_accum

_MODULES = {"lowrank_linear": _ll, "paged_attention": _pa,
            "chunked_prefill": _cp, "flash_attention": _fa,
            "gram_accum": _ga}


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel wrapper since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
