"""Block-sparse forward matmul: y = x @ W over W's active (bk, bn) blocks.

Replaces the TPU kernel ``repro/kernels/block_sparse_matmul.py::_fwd_kernel``
(``pallas_call`` in ``_fwd_call``) with the hand-written CUDA kernel
``csrc/block_sparse_fwd.cu`` for Hopper (sm_90a); the design and its traps
are described there.  W is given by its CSC pack (``core/pack.py``):
``idx[j, :cnt[j]]`` are the active K-blocks of N-block column j.

Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): decode rows are few,
so the kernel must at least read every active weight block once; the bound
counts those bytes plus x and y once.  The kernel reads only active blocks,
so its bytes scale with block density.

``block_sparse_matmul`` launches the kernel for CUDA tensors (bf16 only: the
main path's config is bf16) and takes the plain PyTorch version
``block_sparse_matmul_plain`` only for CPU tensors.  ``launches`` counts the
kernel launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "block_sparse_matmul",
    "block_sparse_matmul_plain",
    "unpack_block_mask",
    "launches",
]

launches = 0  # kernel launches since import (or since a caller reset it)


def unpack_block_mask(idx: torch.Tensor, cnt: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """CSC ``(idx, cnt)`` -> (n_rows, n_cols) bool block mask."""
    n_cols, width = idx.shape
    live = torch.arange(width, device=idx.device)[None, :] < cnt[:, None]
    cols = torch.arange(n_cols, device=idx.device)[:, None].expand(n_cols, width)
    bm = torch.zeros(n_rows, n_cols, dtype=torch.bool, device=idx.device)
    bm[idx[live].long(), cols[live]] = True
    return bm


def block_sparse_matmul_plain(x, w, idx, cnt, bk: int, bn: int):
    """Plain version: expand the pack to a dense block mask and compute
    ``x @ (w * mask)`` with f32 accumulation, rounded once to x.dtype."""
    mask = unpack_block_mask(idx, cnt, w.shape[0] // bk)
    mask = mask.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    return (x.float() @ (w.float() * mask)).to(x.dtype)


def _check_cuda(x, w, idx, cnt, bm, bn, bk):
    M, K = x.shape
    K2, N = w.shape
    for name, t in (("w", w), ("idx", idx), ("cnt", cnt)):
        if t.device != x.device:
            raise ValueError(f"block_sparse_matmul: {name} on {t.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(
            f"block_sparse_matmul: the CUDA kernel takes bf16 x and w "
            f"(got {x.dtype}, {w.dtype})"
        )
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError("block_sparse_matmul: idx and cnt must be int32")
    if not all(t.is_contiguous() for t in (x, w, idx, cnt)):
        raise ValueError("block_sparse_matmul: inputs must be contiguous")
    if K != K2 or M % bm or K % bk or N % bn:
        raise ValueError(
            f"block_sparse_matmul: shapes x {tuple(x.shape)}, w {tuple(w.shape)} "
            f"do not tile by (bm, bn, bk) = {(bm, bn, bk)}"
        )
    for name, b in (("bm", bm), ("bn", bn), ("bk", bk)):
        if b % 16 or not 16 <= b <= 128:
            raise ValueError(f"block_sparse_matmul: {name}={b} must be a "
                             "multiple of 16 in [16, 128]")
    if idx.dim() != 2 or idx.shape[0] != N // bn or cnt.shape != (N // bn,):
        raise ValueError(
            f"block_sparse_matmul: pack idx {tuple(idx.shape)} / cnt "
            f"{tuple(cnt.shape)} does not match N/bn = {N // bn}"
        )
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("block_sparse_matmul: x and w must be 16-byte aligned")


def _launch(x, w, idx, cnt, bm, bn, bk):
    global launches
    _check_cuda(x, w, idx, cnt, bm, bn, bk)
    lib = _build.load("block_sparse_fwd")
    fn = lib.block_sparse_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                y.data_ptr(), M, K, N, idx.shape[1], bm, bn, bk, stream)
    _build.check(lib, rc, "block_sparse_fwd launch")
    launches += 1
    return y


def block_sparse_matmul(x, w, idx, cnt, *, bm: int, bn: int, bk: int):
    """x (M, K) @ block-sparse w (K, N) -> (M, N) in x.dtype.

    M must be a multiple of ``bm`` (``kernels/ops.py`` pads rows).  CUDA
    tensors run the kernel or raise; CPU tensors run the plain version.
    """
    if x.device.type == "cuda":
        return _launch(x, w, idx, cnt, bm, bn, bk)
    if x.device.type != "cpu":
        raise ValueError(f"block_sparse_matmul: unsupported device {x.device}")
    return block_sparse_matmul_plain(x, w, idx, cnt, bk, bn)
