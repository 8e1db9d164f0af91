"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution (vision frontend stubbed).

[arXiv:2409.12191; hf] 28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936.
Inputs: precomputed patch embeddings (B, n_vision_tokens, d_model) prefix +
text tokens. M-RoPE sections (t,h,w) = (16,24,24) over head_dim//2 = 64.
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, max_seq_len=32768,
    n_vision_tokens=256, mrope_sections=(16, 24, 24),
    rope_theta=1e6, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, max_seq_len=256, n_vision_tokens=8,
    mrope_sections=(4, 2, 2))
