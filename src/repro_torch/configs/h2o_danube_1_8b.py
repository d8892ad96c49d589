"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]. 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
SWA window 4096 on every layer => windowed KV cache.  Same values as the JAX
package's ``configs/h2o_danube_1_8b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=80, d_ff=6912, vocab_size=32000,
    mlp_kind="swiglu", attn_pattern=("local",), window=4096,
    tie_embeddings=False, microbatches=4,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
    mlp_kind="swiglu", attn_pattern=("local",), window=16,
    tie_embeddings=False, q_chunk=64, remat=False,
)
