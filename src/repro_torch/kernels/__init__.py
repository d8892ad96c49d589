"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``block_sparse_matmul`` (csrc/block_sparse_fwd.cu, csrc/block_sparse_bwd.cu)
and ``flash_attention`` (csrc/flash_fwd.cu, csrc/flash_bwd.cu) each launch
their kernels for CUDA tensors and run the plain versions for CPU tensors;
each module counts its launches per kernel.  Import from the submodules.
Nothing is built when a module is imported (kernels/_build.py builds at
first launch).
"""
