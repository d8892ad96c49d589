"""command-r-plus-104b [dense]: GQA, no-bias, PARALLEL attn||FFN block.

[hf:CohereForAI/c4ai-command-r-v01; unverified]. 64L d_model=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000, tied embeddings.  Full attention; the
attention and the FFN read the same normed input and add to the residual
together (``parallel_block``: no ``ln2``).  Same values as the JAX
package's ``configs/command_r_plus_104b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, head_dim=128, d_ff=33792, vocab_size=256000,
    mlp_kind="swiglu", parallel_block=True, tie_embeddings=True, fsdp=True,
    loss_chunks=8, microbatches=16, remat_group=4,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
    mlp_kind="swiglu", parallel_block=True, tie_embeddings=True,
    q_chunk=64, remat=False,
)
