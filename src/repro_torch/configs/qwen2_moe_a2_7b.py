"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. 24L d_model=2048 16H (GQA kv=16)
moe_d_ff=1408 vocab=151936; the shared experts form one SwiGLU MLP of
4 x 1408 = 5632.  Same values as the JAX package's
``configs/qwen2_moe_a2_7b.py``; its training-only fields (``fsdp``,
``microbatches``, ``loss_chunks``) are carried over as data and serving on
one device ignores them.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=0, vocab_size=151936,
    n_experts=60, top_k=4, n_shared_experts=4, moe_d_ff=1408,
    tie_embeddings=False, loss_chunks=4, microbatches=4, fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=128,
    n_experts=6, top_k=2, n_shared_experts=1, moe_d_ff=32,
    tie_embeddings=False, q_chunk=64, remat=False,
)
