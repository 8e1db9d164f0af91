"""Configuration dataclasses of the port (copy of ``repro/config.py``).

Only the fields the port reads are kept: ``MoEConfig``, the attention-only
decoders of ``ModelConfig`` (dense GQA, gemma2's local/global alternation,
softcaps and sandwich norms, olmo's non-parametric norm, minicpm's scaling,
deepseek-v2's MLA dims, the MoE layer pattern and qwen2-vl's vision prefix
and M-RoPE sections), ``TrainConfig`` and the COALA / baseline settings of
``CompressConfig``. The knobs of the SSM, hybrid and enc-dec families wait
with those families.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one FFN layer family."""
    num_experts: int = 0              # routed experts (0 = dense FFN)
    top_k: int = 0
    num_shared: int = 0               # always-on shared experts
    d_ff_expert: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    min_capacity: int = 4
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


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

    moe: MoEConfig = MoEConfig()

    # gemma2-style
    local_window: int = 0             # 0 = all-global; else alternate local/global
    query_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_block_norm: bool = False     # sandwich norms (gemma2)

    # olmo: non-parametric LayerNorm
    nonparametric_norm: bool = False

    # minicpm mup-ish scaling
    scale_emb: float = 1.0
    scale_depth: float = 0.0          # 0 = off; else residual scaled by scale_depth/sqrt(L)
    dim_model_base: int = 0           # 0 = off; logits scaled by d_model/dim_model_base

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0             # 0 = plain GQA
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE layer pattern: layer i uses MoE if i >= first_dense and pattern hit
    moe_every: int = 1                # MoE FFN if (i % moe_every == moe_offset)
    moe_offset: int = 0
    first_k_dense: int = 0            # first k layers use dense FFN (deepseek)

    # vlm (qwen2-vl)
    n_vision_tokens: int = 0          # prefix of precomputed patch embeds
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # M-RoPE t/h/w splits

    # ffn activation: "silu" | "gelu" | "gelu_tanh"
    act: str = "silu"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def uses_moe(self) -> bool:
        return self.moe.num_experts > 0

    def layer_kind(self, i: int) -> str:
        """'attn' for every decoder layer of the ported families (the
        recurrent kinds of the ssm and hybrid families are not ported). The
        reference config's API: the port's ``LM`` admits only the dense, moe
        and vlm families, all attention, so its model code does not call
        it."""
        if self.family == "ssm":
            raise NotImplementedError(
                "family 'ssm' (xLSTM mLSTM/sLSTM layers) is not ported yet")
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.uses_moe:
            return False
        if i < self.first_k_dense:
            return False
        return i % self.moe_every == self.moe_offset

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
    adaptive_rank: bool = False       # water-filling per-layer ranks (beyond-paper)
