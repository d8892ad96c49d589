"""Block-sparse matmul y = x @ W over W's active (bk, bn) blocks, forward
and backward.

Replaces three TPU kernels of ``repro/kernels/block_sparse_matmul.py`` with
hand-written CUDA kernels for Hopper (sm_90a); the designs and their traps
are described in the sources:

  K1 ``_fwd_kernel`` (``_fwd_call``)  y = x @ W over the CSC pack
     ``idx[j, :cnt[j]]``                       -> csrc/block_sparse_fwd.cu
  K2 ``_dx_kernel`` (``_dx_call``)    dx = g @ W^T over the CSR pack
     ``ridx[k, :rcnt[k]]``                     -> csrc/block_sparse_bwd.cu
  K3 ``_dw_kernel`` (``_dw_call``)    dw = x^T @ g on the active blocks of
     a CSC pack, zeros elsewhere               -> csrc/block_sparse_bwd.cu

Each runs in bf16 (tensor cores) and in f32 (full-precision FFMA: the
reference's MLP computes in the f32 residual's dtype), accumulating in f32
and rounding once to the element type.

Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s f32
FFMA): each kernel must at least read the active weight (or gradient)
blocks and its dense operands once; decode rows are few, so K1 is bound by
bytes there, and the training shapes (M = 2048) sit below the bf16 ridge.

Every wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (``*_plain``) only for CPU tensors.  ``launches``,
``dx_launches`` and ``dw_launches`` count kernel launches, so a run can show
that its path went through the kernels.  ``BlockSparseMatmul`` and
``TopkastBlockSparseMatmul`` are the differentiable forms (the reference's
custom VJPs ``_bs_fwd/_bs_bwd`` and ``_tk_fwd/_tk_bwd``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "BlockSparseMatmul",
    "TopkastBlockSparseMatmul",
    "block_sparse_dw",
    "block_sparse_dw_plain",
    "block_sparse_dx",
    "block_sparse_dx_plain",
    "block_sparse_matmul",
    "block_sparse_matmul_plain",
    "csr_of",
    "dx_launches",
    "dw_launches",
    "launches",
    "matmul_error_bound",
    "unpack_block_mask",
]

# kernel launches since import (or since a caller reset them)
launches = 0     # K1
dx_launches = 0  # K2
dw_launches = 0  # K3

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def unpack_block_mask(idx: torch.Tensor, cnt: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """CSC ``(idx, cnt)`` -> (n_rows, n_cols) bool block mask, without a
    host sync: padded slots scatter into a dummy trailing row."""
    n_cols, width = idx.shape
    live = torch.arange(width, device=idx.device)[None, :] < cnt[:, None]
    rows = torch.where(live, idx.long(), n_rows)
    bm = torch.zeros(n_cols, n_rows + 1, dtype=torch.bool, device=idx.device)
    bm.scatter_(1, rows, True)
    return bm[:, :n_rows].T.contiguous()


def csr_of(idx: torch.Tensor, cnt: torch.Tensor, n_rows: int):
    """CSC ``(idx, cnt)`` -> CSR ``(ridx, rcnt)`` at the worst-case width
    (all N-blocks), ids ascending, padded slots 0: the reference's traced
    fallback when a bare CSC tuple comes without its CSR view."""
    bm = unpack_block_mask(idx, cnt, n_rows)
    rcnt = bm.sum(1).to(torch.int32)
    order = torch.argsort((~bm).to(torch.uint8), dim=1, stable=True)
    live = torch.arange(bm.shape[1], device=bm.device)[None, :] < rcnt[:, None]
    return torch.where(live, order, 0).to(torch.int32).contiguous(), rcnt


def _dense_mask(idx, cnt, n_rows: int, bk: int, bn: int) -> torch.Tensor:
    mask = unpack_block_mask(idx, cnt, n_rows)
    return mask.repeat_interleave(bk, 0).repeat_interleave(bn, 1)


def block_sparse_matmul_plain(x, w, idx, cnt, bk: int, bn: int):
    """Plain K1: expand the pack to a dense block mask and compute
    ``x @ (w * mask)`` with f32 accumulation, rounded once to x.dtype."""
    mask = _dense_mask(idx, cnt, w.shape[0] // bk, bk, bn)
    return (x.float() @ (w.float() * mask)).to(x.dtype)


def block_sparse_dx_plain(g, w, ridx, rcnt, bk: int, bn: int):
    """Plain K2: ``g @ (w * mask)^T`` in f32 over the CSR pack's blocks,
    rounded once to g.dtype."""
    mask = _dense_mask(ridx, rcnt, w.shape[1] // bn, bn, bk).T
    return (g.float() @ (w.float() * mask).T).to(g.dtype)


def block_sparse_dw_plain(x, g, idx, cnt, bk: int, bn: int):
    """Plain K3: ``(x^T @ g) * mask`` in f32 over the CSC pack's blocks,
    zeros elsewhere, rounded once to x.dtype."""
    mask = _dense_mask(idx, cnt, x.shape[1] // bk, bk, bn)
    return ((x.float().T @ g.float()) * mask).to(x.dtype)


def matmul_error_bound(out_plain, abs_prod, n: int):
    """Per-element bound on |kernel - plain| for an output that both sides
    compute as an f32 sum of ``n`` products and round once to
    ``out_plain.dtype``.  ``abs_prod`` is the plain product of the operands'
    absolute values (|a| @ |b| over the same blocks).  Each f32 sum is
    within n * 2**-24 * abs_prod of the exact one (the worst case of
    recursive summation, whatever the order), so the two sums within twice
    that; a bf16 output adds one rounding per side, 2**-8 |y| each."""
    bound = 2.0 * n * 2.0**-24 * abs_prod.float()
    if out_plain.dtype == torch.bfloat16:
        bound = bound + 2.0**-7 * out_plain.float().abs()
    return bound


def _suffix(what: str, *ts) -> str:
    dt = ts[0].dtype
    if dt not in _SUFFIX or any(t.dtype != dt for t in ts):
        raise TypeError(f"{what}: the CUDA kernel takes bf16 or f32 operands of "
                        f"one dtype (got {', '.join(str(t.dtype) for t in ts)})")
    return _SUFFIX[dt]


def _check_cuda(what, a, b, packs, blocks, tiles, same):
    """Device, dtype, index type, contiguity, tiling and alignment of one
    launch; ``tiles`` lists (extent, block) pairs that must divide, ``same``
    (extent, extent) pairs that must be equal."""
    for name, t in [("second operand", b)] + list(packs.items()):
        if t.device != a.device:
            raise ValueError(f"{what}: {name} on {t.device}, first operand on {a.device}")
    suffix = _suffix(what, a, b)
    if any(t.dtype != torch.int32 for t in packs.values()):
        raise TypeError(f"{what}: pack index arrays must be int32")
    if not all(t.is_contiguous() for t in (a, b, *packs.values())):
        raise ValueError(f"{what}: inputs must be contiguous")
    for name, blk in blocks.items():
        if blk % 16 or not 16 <= blk <= 128:
            raise ValueError(f"{what}: {name}={blk} must be a multiple of 16 in [16, 128]")
    if any(e % blk for e, blk in tiles) or any(e != f for e, f in same):
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, {tuple(b.shape)} do "
                         f"not match or do not tile by the blocks {blocks}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return suffix


def _entry(lib_name: str, fn_name: str, n_ptr: int, n_int: int):
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
    fn.restype = _I
    return lib, fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def block_sparse_matmul(x, w, idx, cnt, *, bm: int, bn: int, bk: int):
    """K1: x (M, K) @ block-sparse w (K, N) -> (M, N) in x.dtype.

    M must be a multiple of ``bm`` (``kernels/ops.py`` pads rows).  CUDA
    tensors run the kernel or raise; CPU tensors run the plain version.
    """
    global launches
    if x.device.type == "cpu":
        return block_sparse_matmul_plain(x, w, idx, cnt, bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul: unsupported device {x.device}")
    (M, K), N = x.shape, w.shape[1]
    s = _check_cuda("block_sparse_matmul", x, w, {"idx": idx, "cnt": cnt},
                    {"bm": bm, "bn": bn, "bk": bk},
                    [(M, bm), (K, bk), (N, bn)], [(w.shape[0], K)])
    if idx.dim() != 2 or idx.shape[0] != N // bn or cnt.shape != (N // bn,):
        raise ValueError(f"block_sparse_matmul: pack idx {tuple(idx.shape)} / cnt "
                         f"{tuple(cnt.shape)} does not match N/bn = {N // bn}")
    lib, fn = _entry("block_sparse_fwd", f"block_sparse_fwd_{s}", 5, 7)
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                y.data_ptr(), M, K, N, idx.shape[1], bm, bn, bk, _stream(x))
    _build.check(lib, rc, "block_sparse_fwd launch")
    launches += 1
    return y


def block_sparse_dx(g, w, ridx, rcnt, *, bm: int, bn: int, bk: int):
    """K2: g (M, N) @ block-sparse w (K, N)^T -> dx (M, K) in g.dtype, over
    the CSR pack ``ridx (K/bk, row_width)`` / ``rcnt (K/bk,)``.  M must be a
    multiple of ``bm``."""
    global dx_launches
    if g.device.type == "cpu":
        return block_sparse_dx_plain(g, w, ridx, rcnt, bk, bn)
    if g.device.type != "cuda":
        raise ValueError(f"block_sparse_dx: unsupported device {g.device}")
    (M, N), K = g.shape, w.shape[0]
    s = _check_cuda("block_sparse_dx", g, w, {"ridx": ridx, "rcnt": rcnt},
                    {"bm": bm, "bn": bn, "bk": bk},
                    [(M, bm), (K, bk), (N, bn)], [(w.shape[1], N)])
    if ridx.dim() != 2 or ridx.shape[0] != K // bk or rcnt.shape != (K // bk,):
        raise ValueError(f"block_sparse_dx: CSR ridx {tuple(ridx.shape)} / rcnt "
                         f"{tuple(rcnt.shape)} does not match K/bk = {K // bk}")
    lib, fn = _entry("block_sparse_bwd", f"block_sparse_dx_{s}", 5, 7)
    dx = torch.empty(M, K, dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        rc = fn(g.data_ptr(), w.data_ptr(), ridx.data_ptr(), rcnt.data_ptr(),
                dx.data_ptr(), M, K, N, ridx.shape[1], bm, bn, bk, _stream(g))
    _build.check(lib, rc, "block_sparse_dx launch")
    dx_launches += 1
    return dx


def block_sparse_dw(x, g, idx, cnt, *, bn: int, bk: int):
    """K3: dw (K, N) in x.dtype holding x^T @ g on the active blocks of the
    CSC pack ``idx``/``cnt`` and zeros elsewhere.  x (M, K), g (M, N); M a
    multiple of 16 (``kernels/ops.py`` pads rows)."""
    global dw_launches
    if x.device.type == "cpu":
        return block_sparse_dw_plain(x, g, idx, cnt, bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_dw: unsupported device {x.device}")
    (M, K), N = x.shape, g.shape[1]
    s = _check_cuda("block_sparse_dw", x, g, {"idx": idx, "cnt": cnt},
                    {"bn": bn, "bk": bk}, [(M, 16), (K, bk), (N, bn)],
                    [(g.shape[0], M)])
    if idx.dim() != 2 or idx.shape[0] != N // bn or cnt.shape != (N // bn,):
        raise ValueError(f"block_sparse_dw: pack idx {tuple(idx.shape)} / cnt "
                         f"{tuple(cnt.shape)} does not match N/bn = {N // bn}")
    lib, fn = _entry("block_sparse_bwd", f"block_sparse_dw_{s}", 5, 6)
    dw = torch.zeros(K, N, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), g.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                dw.data_ptr(), M, K, N, idx.shape[1], bn, bk, _stream(x))
    _build.check(lib, rc, "block_sparse_dw launch")
    dw_launches += 1
    return dw


class BlockSparseMatmul(torch.autograd.Function):
    """y = x @ W on the CSC pack; backward dx on the CSR pack (K2) and dw
    on the same CSC pack (K3), as the reference's ``_bs_fwd/_bs_bwd``.
    ``ridx``/``rcnt`` None derives the CSR at the worst-case width."""

    @staticmethod
    def forward(ctx, x, w, idx, cnt, ridx, rcnt, bm, bn, bk):
        ctx.save_for_backward(x, w, idx, cnt, ridx, rcnt)
        ctx.blocks = (bm, bn, bk)
        return block_sparse_matmul(x, w, idx, cnt, bm=bm, bn=bn, bk=bk)

    @staticmethod
    def backward(ctx, g):
        x, w, idx, cnt, ridx, rcnt = ctx.saved_tensors
        return _backward(ctx, g, x, w, idx, cnt, ridx, rcnt, idx, cnt) + (None,) * 7


class TopkastBlockSparseMatmul(torch.autograd.Function):
    """Forward and dx on the forward pack (A), dw on the Top-KAST superset
    CSC ``bidx``/``bcnt`` (B ⊇ A), as the reference's ``_tk_fwd/_tk_bwd``:
    dw is the dense gradient restricted to B's blocks."""

    @staticmethod
    def forward(ctx, x, w, idx, cnt, ridx, rcnt, bidx, bcnt, bm, bn, bk):
        ctx.save_for_backward(x, w, idx, cnt, ridx, rcnt, bidx, bcnt)
        ctx.blocks = (bm, bn, bk)
        return block_sparse_matmul(x, w, idx, cnt, bm=bm, bn=bn, bk=bk)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, *ctx.saved_tensors) + (None,) * 9


def _backward(ctx, g, x, w, idx, cnt, ridx, rcnt, didx, dcnt):
    bm, bn, bk = ctx.blocks
    g = g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        if ridx is None:
            ridx, rcnt = csr_of(idx, cnt, w.shape[0] // bk)
        dx = block_sparse_dx(g, w, ridx, rcnt, bm=bm, bn=bn, bk=bk)
    if ctx.needs_input_grad[1]:
        dw = block_sparse_dw(x, g, didx, dcnt, bn=bn, bk=bk)
    return dx, dw
