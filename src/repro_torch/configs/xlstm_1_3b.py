"""xlstm-1.3b [ssm]: mLSTM + sLSTM blocks, 7:1 ratio.

[arXiv:2405.04517]. 48L d_model=2048 4H vocab=50304 (padded to 50432),
d_ff=0, tied embeddings.  Every 8th block is sLSTM (a true recurrence),
the rest mLSTM (matrix memory, chunkwise-parallel training, O(1)-state
decode).  Same values as the JAX package's ``configs/xlstm_1_3b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", block_type="xlstm", n_layers=48,
    d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512, d_ff=0,
    vocab_size=50304, slstm_every=8, tie_embeddings=True, microbatches=8,
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke", family="ssm", block_type="xlstm", n_layers=4,
    d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=0,
    vocab_size=128, slstm_every=2, tie_embeddings=True, q_chunk=64, remat=False,
)
