"""gemma2-27b [dense]: local(4096)/global alternating attention, softcaps.

[arXiv:2408.00118; hf] 46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000.
head_dim=128 (q/k/v project 4608->4096); query scale (d_model/n_heads)^-0.5;
attn softcap 50, final softcap 30; sandwich (post-block) RMSNorms; GeGLU.
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000, max_seq_len=524288,
    local_window=4096, query_scale=(4608 / 32) ** -0.5,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norm=True, scale_emb=4608 ** 0.5,
    act="gelu_tanh", tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, max_seq_len=256, local_window=32,
    query_scale=(64 / 4) ** -0.5, scale_emb=8.0)
