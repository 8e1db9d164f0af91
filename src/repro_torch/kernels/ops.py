"""Public kernel entry points of the port (counterpart of ``repro/kernels/ops.py``).

Dispatch goes by the device of the tensors, which the caller chose: a CPU
tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written CUDA kernel (built from ``repro_torch/csrc`` at first use) or
raises. There is no automatic fallback.

Launch counts. Each wrapper adds one to its module's ``launches`` where it
launches its kernel. Inside a CUDA-graph capture a wrapper call records a
kernel node instead, so ``captured_launches`` takes those calls back out of
the eager counts and hands them to the graph's owner, which adds them with
``add_replayed`` on every replay. ``launch_counts`` reports the sum.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

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
_replayed: Dict[str, int] = dict.fromkeys(_MODULES, 0)


def eager_launch_counts() -> Dict[str, int]:
    """Launches made by wrapper calls outside any graph capture."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def replayed_launch_counts() -> Dict[str, int]:
    """Launches made by CUDA-graph replays (each graph's kernels per replay)."""
    return dict(_replayed)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last reset: eager + replayed."""
    return {name: mod.launches + _replayed[name]
            for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in _MODULES.items():
        mod.launches = 0
        _replayed[name] = 0
    _ll.backward_launches = 0


def backward_launch_counts() -> Dict[str, int]:
    """Of the eager launches, those made by a backward (only lowrank_linear
    has one: its dx)."""
    return {"lowrank_linear": _ll.backward_launches}


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """Wrap a CUDA-graph capture: yields a dict that, on exit, holds the
    kernels' launches per replay of the captured graph; the wrapper calls
    made inside are taken back out of the eager counts."""
    before = eager_launch_counts()
    rec: Dict[str, int] = {}
    try:
        yield rec
    finally:
        for name, mod in _MODULES.items():
            rec[name] = mod.launches - before[name]
            mod.launches = before[name]


def add_replayed(counts: Dict[str, int]) -> None:
    """Count one replay of a graph whose per-replay launches are ``counts``."""
    for name, n in counts.items():
        _replayed[name] += n
