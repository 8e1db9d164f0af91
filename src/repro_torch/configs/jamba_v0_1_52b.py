"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536.
Layer i is attention iff i % 8 == 4 (one per Jamba block of 8); MoE replaces
the MLP on every other layer (i % 2 == 1), 16 experts top-2, no shared.
Mamba: d_state=16, d_conv=4, expand=2, dt_rank=256.
"""
import dataclasses
from repro_torch.config import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, max_seq_len=524288,
    attn_every=8, attn_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, d_ff_expert=14336),
    moe_every=2, moe_offset=1,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, max_seq_len=256, attn_every=4, attn_offset=2,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=0, d_ff_expert=32,
                  min_capacity=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=16))
