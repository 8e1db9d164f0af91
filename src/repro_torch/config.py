"""Configuration dataclasses of the port (copy of ``repro/config.py``).

Only the fields the port reads are kept: the dense GQA decoder of
``ModelConfig``, ``TrainConfig`` and the COALA / baseline settings of
``CompressConfig``. The family knobs of MoE, SSM, MLA, enc-dec and VLM
models wait with those families.
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
class TrainConfig:
    """AdamW + schedule settings (copy of ``repro/config.py:167-184``).

    ``remat`` and ``grad_compress_pods`` are kept so that configs carry over,
    but the port reads neither: it trains eagerly without activation
    rematerialization and on one device, so there is no cross-pod reduce to
    compress."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1           # WSD decay fraction
    microbatches: int = 1             # grad accumulation
    remat: str = "dots"               # none | dots | full (not acted on)
    grad_compress_pods: bool = False  # not acted on (single device)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    """COALA / baseline compression settings."""
    method: str = "coala"             # coala | svd_llm | svd_llm_v2 | asvd | svd
    ratio: float = 0.7                # kept parameter fraction of compressed layers
    lam: float = 4.0                  # λ in Eq.(5)
    mu: float = -1.0                  # explicit μ; -1 = per-layer Eq.(5)
    rank: int = 0                     # explicit rank overrides ratio when >0
    use_rsvd: bool = False            # beyond-paper randomized SVD path
    rsvd_oversample: int = 8
    rsvd_power_iters: int = 2
