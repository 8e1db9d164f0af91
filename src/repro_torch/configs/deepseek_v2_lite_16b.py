"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 2 shared + 64 routed top-6.

[arXiv:2405.04434; hf] 27L d_model=2048 16H d_ff_expert=1408 vocab=102400.
Assignment line says both "MoE 64e" and "160 routed"; HF config is 64 routed
(2 shared, top-6) — we follow 64e (see DESIGN.md §7).
MLA dims per HF: q_head = 128 nope + 64 rope, v_head = 128, kv_lora_rank 512.
"""
import dataclasses
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    head_dim=192, vocab_size=102400, max_seq_len=524288,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
    first_k_dense=1,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    head_dim=48, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
    v_head_dim=32, vocab_size=256, max_seq_len=256,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_ff_expert=32,
                  min_capacity=2))
