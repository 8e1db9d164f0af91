"""xlstm-1.3b [ssm]: mixed sLSTM + mLSTM blocks (1 sLSTM per 8 layers).

[arXiv:2405.04517; unverified] 48L d_model=2048 4H d_ff=0 vocab=50304.
Blocks carry their own gated projections (d_ff=0 per assignment).
"""
import dataclasses
from repro_torch.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, max_seq_len=524288,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0),
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
    max_seq_len=256, xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0))
