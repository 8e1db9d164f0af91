"""minicpm-2b [dense]: llama-like with mup-style scaling + WSD schedule.

[arXiv:2404.06395; hf] 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
scale_emb=12, scale_depth=1.4, dim_model_base=256 per the paper; the WSD
learning-rate schedule lives in train/optimizer.py (schedule="wsd").
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, max_seq_len=32768,
    scale_emb=12.0, scale_depth=1.4, dim_model_base=256,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, max_seq_len=256)
