"""grok-1-314b [moe]: 8 experts top-2, attention and final logit soft-caps.

[hf:xai-org/grok-1; unverified]. 64L d_model=6144 48H (GQA kv=8)
moe_d_ff=32768 vocab=131072, untied.  Every layer's FFN is the routed MoE
(no shared experts); attention logits are capped at 30 inside the flash
kernels, the final logits at 50.  The only config with bf16 parameters
(``param_dtype``: the masters are drawn and kept in bf16) and bf16
gradient accumulation over its 16 microbatches.  Same values as the JAX
package's ``configs/grok_1_314b.py``; its sharding fields (``fsdp``) are
carried over as data.
"""
from .base import ModelConfig, SparseConfig

_SP = SparseConfig(attn_kernel="flash_tight")

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=0, vocab_size=131072,
    n_experts=8, top_k=2, moe_d_ff=32768, logit_softcap=30.0,
    final_softcap=50.0, tie_embeddings=False, fsdp=True, loss_chunks=4,
    microbatches=16, param_dtype="bfloat16", grad_accum_dtype="bfloat16",
    sparse=_SP,
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128,
    n_experts=4, top_k=2, moe_d_ff=64, logit_softcap=30.0, final_softcap=50.0,
    tie_embeddings=False, q_chunk=64, remat=False, sparse=_SP,
)
