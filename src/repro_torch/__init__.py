"""PyTorch/CUDA port of the RigL reproduction (the JAX package ``repro`` is
the reference).  Slice 1 serves the dense-family transformer
(h2o-danube-1.8b) through hand-written Hopper kernels: the block-sparse
forward matmul and the flash-attention forward.  Imports ``torch`` and
numpy only, never ``jax`` and nothing of ``repro``.
"""
