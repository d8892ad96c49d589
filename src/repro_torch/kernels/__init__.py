"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``block_sparse_matmul`` (csrc/block_sparse_fwd.cu, csrc/block_sparse_bwd.cu,
csrc/block_sparse_grouped.cu), ``masked_matmul`` (csrc/masked_matmul.cu),
``flash_attention`` (csrc/flash_fwd.cu, csrc/flash_bwd.cu,
csrc/flash_paged.cu) and ``topk_threshold`` (csrc/topk_threshold.cu) each launch
their kernels for CUDA tensors and run the plain versions for CPU tensors;
each module counts its launches per kernel.  Import from the submodules.
Nothing is built when a module is imported (kernels/_build.py builds at
first launch).
"""
