"""mistral-large-123b [dense]: [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.  Full attention on
every layer, so every KV cache is one global group and the serving engine's
shared-prefix cache applies.  Same values as the JAX package's
``configs/mistral_large_123b.py``; its training-only fields (``fsdp``,
``microbatches``, ``remat_group``, ``loss_chunks``) are carried over as data
and serving on one device ignores them.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, head_dim=128, d_ff=28672, vocab_size=32768,
    mlp_kind="swiglu", tie_embeddings=False, fsdp=True,
    microbatches=16, remat_group=4, loss_chunks=4,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=128,
    mlp_kind="swiglu", tie_embeddings=False, q_chunk=64, remat=False,
)
