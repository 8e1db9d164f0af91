"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained experts.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (kv=16) d_ff_expert=1408
vocab=102400; first layer dense FFN (d_ff=10944).
"""
import dataclasses
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab_size=102400, max_seq_len=524288,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
    first_k_dense=1,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, max_seq_len=256,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_ff_expert=32,
                  min_capacity=2))
