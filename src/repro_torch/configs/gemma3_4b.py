"""gemma3-4b [dense]: 5:1 local:global interleaving, QK-norm, sandwich norms.

[hf:google/gemma-3-1b-pt; unverified]. 34L d_model=2560 8H (GQA kv=4)
head_dim=256 d_ff=10240 vocab=262144, tied embeddings, GeGLU (tanh GELU).
Local window 1024; every 6th layer global.  q and k are rmsnormed over
head_dim before RoPE (``qk_norm``); the attention and the FFN outputs are
rmsnormed before they join the residual (``post_norms``).  Same values as
the JAX package's ``configs/gemma3_4b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240, vocab_size=262144,
    mlp_kind="geglu", attn_pattern=("local",) * 5 + ("global",), window=1024,
    qk_norm=True, post_norms=True, tie_embeddings=True, loss_chunks=8, microbatches=8,
)

SMOKE = ModelConfig(
    name="gemma3-4b-smoke", family="dense", n_layers=6, d_model=64,
    n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=256,
    mlp_kind="geglu", attn_pattern=("local",) * 5 + ("global",), window=16,
    qk_norm=True, post_norms=True, tie_embeddings=True, q_chunk=64, remat=False,
)
