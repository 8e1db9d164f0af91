"""smollm-135m [dense]: llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (kv=3) d_ff=1536 vocab=49152.
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, max_seq_len=32768, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=96,
    vocab_size=256, max_seq_len=256)
