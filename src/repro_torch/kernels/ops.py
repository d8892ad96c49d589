"""Dispatch wrapper around the block-sparse kernels: row padding and packs.

Port of ``_row_tile``, ``_pad_rows`` and the pack-entry path of
``block_sparse_linear`` from the JAX package's ``kernels/ops.py``.  Leading
dims of x are flattened and the rows zero-padded to the row tile (a small
batch shrinks the tile to its 16-padded row count instead of padding to
bm), then trimmed after; autograd drops the padded rows' gradients.  K and
N must be tile-aligned: the block grid is defined by them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .block_sparse_matmul import BlockSparseMatmul, TopkastBlockSparseMatmul

__all__ = ["block_sparse_linear"]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _row_tile(M: int, bm: int) -> tuple[int, int]:
    """(effective row tile, padded M): rows below one tile shrink the tile
    to the 16-padded row count (16 = the bf16 MMA tile's row count)."""
    bm_eff = min(bm, _round_up(M, 16))
    return bm_eff, _round_up(M, bm_eff)


def _pad_rows(x2: torch.Tensor, Mp: int) -> torch.Tensor:
    M = x2.shape[0]
    return x2 if Mp == M else F.pad(x2, (0, 0, 0, Mp - M))


def block_sparse_linear(x, w, *, pack, block=(128, 128, 128)):
    """out = x @ w_blocksparse, visiting only the active (bk x bn) blocks.
    Differentiable: dx runs on the CSR view (K2), dw (K3) on the CSC view,
    or on the Top-KAST superset CSC when the entry carries one.

    pack: a PackState entry (``{"idx", "cnt", "ridx", "rcnt"[, "bidx",
    "bcnt"]}``, core/pack.py) or a bare ``(idx, cnt)`` CSC tuple, on x's
    device.  An entry with ``bidx`` routes to the split-topology VJP
    (``TopkastBlockSparseMatmul``); a bare tuple derives its CSR at the
    worst-case width when differentiated.  block: (bm, bn, bk); bk and bn
    clamp to small layer dims as in the reference.
    """
    bm, bn, bk = block
    *lead, K = x.shape
    N = w.shape[1]
    bk, bn = min(bk, K), min(bn, N)
    if isinstance(pack, dict):
        idx, cnt = pack["idx"], pack["cnt"]
        ridx, rcnt = pack.get("ridx"), pack.get("rcnt")
        bidx, bcnt = pack.get("bidx"), pack.get("bcnt")
    else:
        (idx, cnt), ridx, rcnt, bidx = pack, None, None, None
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    bm_eff, Mp = _row_tile(M, bm)
    x2 = _pad_rows(x2, Mp).contiguous()
    if bidx is not None:
        out = TopkastBlockSparseMatmul.apply(x2, w, idx, cnt, ridx, rcnt, bidx,
                                             bcnt, bm_eff, bn, bk)
    else:
        out = BlockSparseMatmul.apply(x2, w, idx, cnt, ridx, rcnt, bm_eff, bn, bk)
    return out[:M].reshape(*lead, N)
