"""mistral-7b: the paper's Table 3 compression target.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000.
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, max_seq_len=32768, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, max_seq_len=256)
