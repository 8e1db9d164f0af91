"""llama3-1b: the paper's own compression/fine-tuning target (LLaMA3.2-1B).

16L d_model=2048 32H (kv=8) d_ff=8192 vocab=128256.
"""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, max_seq_len=32768, rope_theta=5e5,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, max_seq_len=256)
