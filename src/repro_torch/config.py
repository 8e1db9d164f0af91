"""Configuration dataclasses of the port (copy of ``repro/config.py``).

Only the fields this slice reads are kept: the dense GQA decoder of
``ModelConfig`` and the COALA settings of ``CompressConfig``. The family
knobs of MoE, SSM, MLA, enc-dec and VLM models wait with those families.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``family`` selects the block wiring."""
    name: str = "unnamed"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 128
    vocab_size: int = 256
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    local_window: int = 0             # 0 = all-global; else alternate local/global
    query_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    act: str = "silu"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def layer_is_local_attn(self, i: int) -> bool:
        """gemma2 alternation: even layers local, odd global."""
        return self.local_window > 0 and (i % 2 == 0)


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    """COALA compression settings (the full-SVD path of the paper)."""
    method: str = "coala"
    ratio: float = 0.7                # kept parameter fraction of compressed layers
    lam: float = 4.0                  # λ in Eq.(5)
    mu: float = -1.0                  # explicit μ; -1 = per-layer Eq.(5)
