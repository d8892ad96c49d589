"""hymba-1.5b [hybrid]: parallel attention + mamba heads in every block.

[arXiv:2411.13676; hf]. 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 (padded to 32256), ssm_state=16, ssm_d_inner=3200, tied
embeddings.  Sliding-window attention (window 1024) everywhere except the
global full-attention layers {first, middle, last}.  Same values as the JAX
package's ``configs/hymba_1_5b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", block_type="hymba", n_layers=32,
    d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504,
    vocab_size=32001, attn_pattern=("local",), global_layer_ids=(0, 15, 31),
    window=1024, ssm_state=16, ssm_d_inner=3200, tie_embeddings=True,
    microbatches=4, q_chunk=2048, loss_chunks=4,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid", block_type="hymba", n_layers=4,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, attn_pattern=("local",), global_layer_ids=(0, 3),
    window=16, ssm_state=4, ssm_d_inner=128, tie_embeddings=True,
    q_chunk=64, remat=False,
)
