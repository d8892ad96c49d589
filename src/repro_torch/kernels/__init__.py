"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``block_sparse_matmul`` (csrc/block_sparse_fwd.cu) and ``flash_attention``
(csrc/flash_fwd.cu) each launch their kernel for CUDA tensors and run the
plain version for CPU tensors; each module counts its launches in
``launches``.  Import from the submodules.  Nothing is built when a module
is imported (kernels/_build.py builds at first launch).
"""
