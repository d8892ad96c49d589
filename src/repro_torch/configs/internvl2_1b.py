"""internvl2-1b [vlm]: InternViT frontend (stub) + Qwen2-0.5B-family backbone.

[arXiv:2404.16821; hf]. 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655, tied embeddings.  The vision tower is a stub: a prompt
carries 256 precomputed patch embeddings (``frontend="patch"``,
frontend_dim=1024), projected by the dense ``frontend_proj`` and put in
front of the text's token embeddings; the loss scores the text positions
only.  Same values as the JAX package's ``configs/internvl2_1b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151655,
    mlp_kind="swiglu", frontend="patch", frontend_dim=1024, n_patches=256,
    tie_embeddings=True, microbatches=4, q_chunk=1024, loss_chunks=8,
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
    mlp_kind="swiglu", frontend="patch", frontend_dim=32, n_patches=4,
    tie_embeddings=True, q_chunk=64, remat=False,
)
