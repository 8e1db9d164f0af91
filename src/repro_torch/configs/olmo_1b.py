"""olmo-1b [dense]: non-parametric LayerNorm, SwiGLU, RoPE, weight tying.

[arXiv:2402.00838; hf] 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=50304, max_seq_len=32768,
    nonparametric_norm=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, max_seq_len=256)
