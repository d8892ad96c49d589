"""hubert-xlarge [audio]: encoder-only masked-prediction transformer.

[arXiv:2106.07447; unverified]. 48L d_model=1280 16H d_ff=5120 vocab=504.
The wav2vec2 conv stem is a stub: the input is precomputed frame
embeddings (``frontend="frames"``, frontend_dim=512) projected to d_model
by the dense ``frontend_proj``; there is no token embedding and the head
is its own.  Bidirectional attention (``causal=False``) and a plain GELU
MLP (tanh approximation).  An encoder has no decode step.  Same values as
the JAX package's ``configs/hubert_xlarge.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120, vocab_size=504,
    mlp_kind="gelu", causal=False, frontend="frames", frontend_dim=512,
    tie_embeddings=False, microbatches=4, loss_chunks=4,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=32,
    mlp_kind="gelu", causal=False, frontend="frames", frontend_dim=16,
    tie_embeddings=False, q_chunk=64, remat=False,
)
