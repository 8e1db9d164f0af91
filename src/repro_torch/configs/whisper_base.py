"""whisper-base [audio]: enc-dec, conv frontend stubbed (precomputed frames).

[arXiv:2212.04356; unverified] 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
"""
import dataclasses
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, max_seq_len=32768, n_audio_frames=1500,
    act="gelu", tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, max_seq_len=256, n_audio_frames=32)
