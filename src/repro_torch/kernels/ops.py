"""Dispatch wrappers around the block-sparse and masked kernels: padding
and packs.

Port of ``_row_tile``, ``_pad_rows``, the pack-entry path of
``block_sparse_linear`` and ``fused_block_sparse_linear``,
``masked_linear``, ``topkast_masked_linear``, ``fused_masked_linear`` and
the weight-bank twins ``grouped_block_sparse_linear`` and
``fused_grouped_block_sparse_linear`` (pack-entry path, the Top-KAST split
included), ``grouped_masked_linear``, ``topkast_grouped_masked_linear`` and
``fused_grouped_masked_linear`` from the JAX package's ``kernels/ops.py``,
and ``topk_threshold`` (the k-th-magnitude threshold from K21's histogram).
The fused wrappers' weight cotangent is the new SGD momentum (K7, K8, K19,
K20).  Leading dims of x are flattened (the grouped
wrappers keep the group dim) and the rows zero-padded to the row tile (a
small batch shrinks the tile to its 16-padded row count instead of padding
to bm), then trimmed after; autograd drops the padded rows' gradients.
For block_sparse K and N must be tile-aligned (the block grid is defined
by them); the masked wrappers zero-pad K and N up to their clamped tiles
(masks with zeros, so A ⊆ B still holds) and trim the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .block_sparse_matmul import (
    BlockSparseMatmul,
    GroupedBlockSparseMatmul,
    TopkastBlockSparseMatmul,
    TopkastGroupedBlockSparseMatmul,
)
from .topk_threshold import N_BINS, histogram_abs
from .masked_matmul import (
    FusedGroupedMaskedMatmul,
    FusedMaskedMatmul,
    GroupedMaskedMatmul,
    MaskedMatmul,
    TopkastGroupedMaskedMatmul,
    TopkastMaskedMatmul,
)

__all__ = [
    "block_sparse_linear",
    "fused_block_sparse_linear",
    "fused_grouped_block_sparse_linear",
    "fused_grouped_masked_linear",
    "fused_masked_linear",
    "grouped_block_sparse_linear",
    "grouped_masked_linear",
    "masked_linear",
    "topkast_grouped_masked_linear",
    "topkast_masked_linear",
    "topk_threshold",
]


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


def block_sparse_linear(x, w, *, pack, block=(128, 128, 128), mom=None, seed: int = 0,
                        mu: float = 0.0, wd: float = 0.0, sr: bool = False):
    """out = x @ w_blocksparse, visiting only the active (bk x bn) blocks.
    Differentiable: dx runs on the CSR view (K2), dw (K3) on the CSC view,
    or on the Top-KAST superset CSC when the entry carries one.

    pack: a PackState entry (``{"idx", "cnt", "ridx", "rcnt"[, "bidx",
    "bcnt"]}``, core/pack.py) or a bare ``(idx, cnt)`` CSC tuple, on x's
    device.  An entry with ``bidx`` routes to the split-topology VJP
    (``TopkastBlockSparseMatmul``); a bare tuple derives its CSR at the
    worst-case width when differentiated.  block: (bm, bn, bk); bk and bn
    clamp to small layer dims as in the reference.

    The fused SGD epilogue: given the (K, N) momentum ``mom``, the weight
    cotangent is the new momentum ``mu * mom + x^T g + wd * w`` on the wgrad
    pack's blocks (the superset, else the forward CSC) and zero elsewhere
    (K7 in K3's place); ``sr`` stochastically rounds it onto the bf16 grid
    in the kernel, with the uint32 ``seed``.  K and N must be tile-aligned.
    """
    bm, bn, bk = block
    *lead, K = x.shape
    N = w.shape[1]
    bk, bn = min(bk, K), min(bn, N)
    idx, cnt, ridx, rcnt, bidx, bcnt = _pack_views(pack)
    nnz, live = _live_blocks(pack)
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    bm_eff, Mp = _row_tile(M, bm)
    x2 = _pad_rows(x2, Mp).contiguous()
    if bidx is not None or mom is not None:
        didx, dcnt = (idx, cnt) if bidx is None else (bidx, bcnt)
        out = TopkastBlockSparseMatmul.apply(x2, w, idx, cnt, ridx, rcnt, didx, dcnt,
                                             bm_eff, bn, bk, mom, seed, mu, wd, sr, live, nnz)
    else:
        out = BlockSparseMatmul.apply(x2, w, idx, cnt, ridx, rcnt, bm_eff, bn, bk, live)
    return out[:M].reshape(*lead, N)


def _pack_views(pack):
    """A PackState entry or a bare ``(idx, cnt)`` CSC tuple -> (idx, cnt,
    ridx, rcnt, bidx, bcnt), None for the views it lacks."""
    if isinstance(pack, dict):
        return (pack["idx"], pack["cnt"], pack.get("ridx"), pack.get("rcnt"),
                pack.get("bidx"), pack.get("bcnt"))
    idx, cnt = pack
    return idx, cnt, None, None, None, None


def _live_blocks(pack):
    """(the forward pack's active blocks, the wgrad pack's) as host ints,
    for K1/K4's and K3/K6's plans: a PackState entry's ``nnz``, and its
    ``bnnz`` (the superset) or ``nnz``; None for a bare tuple or an entry
    without them (a plan then counts every slot).  Read from the entry,
    never from the device's counts."""
    if not isinstance(pack, dict):
        return None, None
    nnz = pack.get("nnz")
    return nnz, (pack.get("bnnz") if "bidx" in pack else nnz)


def fused_block_sparse_linear(x, w, mom, seed: int, *, mu: float, wd: float, sr: bool,
                              pack, block=(128, 128, 128)):
    """``block_sparse_linear`` with the fused SGD epilogue (K7)."""
    return block_sparse_linear(x, w, pack=pack, block=block, mom=mom, seed=seed, mu=mu,
                               wd=wd, sr=sr)


def _masked_operands(x, w, masks, block):
    """Flatten and pad x's rows to the row tile and K/N to the clamped tiles
    (``w`` and every tensor of ``masks`` with zeros) -> (x2, w, masks, M,
    lead, (bm_eff, bn, bk))."""
    bm, bn, bk = block
    *lead, K = x.shape
    N = w.shape[1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    bm_eff, Mp = _row_tile(M, bm)
    x2 = _pad_rows(x2, Mp)
    # pad K/N up to their (clamped) tiles; zero pad-weights contribute nothing
    Kp = _round_up(K, min(bk, K))
    Np = _round_up(N, min(bn, N))
    if Kp != K:
        x2 = F.pad(x2, (0, Kp - K))
    if (Kp, Np) != (K, N):
        w = F.pad(w, (0, Np - N, 0, Kp - K))
        masks = [F.pad(m, (0, Np - N, 0, Kp - K)) for m in masks]
    blocks = (bm_eff, min(bn, Np), min(bk, Kp))
    return (x2.contiguous(), w.contiguous(), [m.contiguous() for m in masks], M,
            lead, blocks)


def masked_linear(x, w, mask, *, block=(128, 128, 128)):
    """out = x @ (w * mask) with the mask fused into the kernels (K13
    forward, K14 dgrad and K15 wgrad on the same mask): any pattern, the
    masked weight never written to device memory.  block: (bm, bn, bk)."""
    N = w.shape[1]
    x2, w, (mask,), M, lead, blk = _masked_operands(x, w, [mask], block)
    out = MaskedMatmul.apply(x2, w, mask, *blk)
    return out[:M, :N].reshape(*lead, N)


def topkast_masked_linear(x, w, mask, bwd_mask, *, block=(128, 128, 128)):
    """out = x @ (w * mask), weight gradient masked by ``bwd_mask`` ⊇ mask
    (the Top-KAST split: forward and dgrad on A, wgrad K15 on B)."""
    N = w.shape[1]
    x2, w, (mask, bwd_mask), M, lead, blk = _masked_operands(x, w, [mask, bwd_mask],
                                                            block)
    out = TopkastMaskedMatmul.apply(x2, w, mask, bwd_mask, *blk)
    return out[:M, :N].reshape(*lead, N)


def fused_masked_linear(x, w, mask, mom, seed: int, *, mu: float, wd: float,
                        sr: bool, bwd_mask=None, block=(128, 128, 128)):
    """``masked_linear`` whose weight cotangent is the new SGD momentum
    ``(mu * mom + x^T g + wd * w) * wgrad_mask`` (K19), where wgrad_mask is
    ``bwd_mask`` (the Top-KAST superset) when given, else ``mask``.  mom
    rides the same zero padding as w; the pad's backward trims the
    cotangent back to (K, N).  ``sr`` stochastically rounds the momentum
    onto the bf16 grid in the kernel, with the uint32 ``seed``."""
    N = w.shape[1]
    wgm = mask if bwd_mask is None else bwd_mask
    x2, w, (mask, wgm, mom), M, lead, blk = _masked_operands(x, w, [mask, wgm, mom],
                                                            block)
    out = FusedMaskedMatmul.apply(x2, w, mask, wgm, mom, seed, mu, wd, sr, *blk)
    return out[:M, :N].reshape(*lead, N)


def grouped_block_sparse_linear(x, w, *, pack, block=(128, 128, 128), mom=None,
                                seed: int = 0, mu: float = 0.0, wd: float = 0.0,
                                sr: bool = False):
    """out[g] = x[g] @ w_blocksparse[g] for every group of a (G, K, N) weight
    bank, ONE launch (K4), visiting only each group's active blocks.

    x: (G, M, K) -> (G, M, N).  pack: a grouped PackState entry
    (``idx (G, N/bn, width)`` etc., per-group CSC and CSR at one shared
    width each, core/pack.py) or a bare stacked ``(idx, cnt)`` tuple, on x's
    device.  Differentiable: dx on the stacked CSR (K5; a bare tuple derives
    it at the worst-case width), dw (K6) on the stacked CSC, or, when the
    entry carries the Top-KAST superset ``bidx``/``bcnt``, on the superset
    (``TopkastGroupedBlockSparseMatmul``).  A group with no active block (a
    dead expert) outputs zeros and gets zero gradients.  Given the (G, K, N)
    momentum ``mom``, the weight cotangent is the new SGD momentum on each
    group's wgrad blocks (K8 in K6's place), as in ``block_sparse_linear``.
    M is padded to the row tile; K and N must be tile-aligned.
    """
    bm, bn, bk = block
    G, M, K = x.shape
    N = w.shape[2]
    bk, bn = min(bk, K), min(bn, N)
    idx, cnt, ridx, rcnt, bidx, bcnt = _pack_views(pack)
    nnz, live = _live_blocks(pack)
    bm_eff, Mp = _row_tile(M, bm)
    if Mp != M:
        x = F.pad(x, (0, 0, 0, Mp - M))
    if bidx is not None or mom is not None:
        didx, dcnt = (idx, cnt) if bidx is None else (bidx, bcnt)
        out = TopkastGroupedBlockSparseMatmul.apply(
            x.contiguous(), w, idx, cnt, ridx, rcnt, didx, dcnt, bm_eff, bn, bk, mom, seed,
            mu, wd, sr, live, nnz)
    else:
        out = GroupedBlockSparseMatmul.apply(x.contiguous(), w, idx, cnt, ridx, rcnt,
                                             bm_eff, bn, bk, live)
    return out[:, :M]


def fused_grouped_block_sparse_linear(x, w, mom, seed: int, *, mu: float, wd: float,
                                      sr: bool, pack, block=(128, 128, 128)):
    """``grouped_block_sparse_linear`` with the fused SGD epilogue (K8)."""
    return grouped_block_sparse_linear(x, w, pack=pack, block=block, mom=mom, seed=seed,
                                       mu=mu, wd=wd, sr=sr)


def _grouped_masked_operands(x, w, masks, block):
    """Pad x's rows to the row tile and K/N to the clamped tiles (``w`` and
    every tensor of ``masks`` with zeros, so A ⊆ B still holds) -> (x, w,
    masks, (bm_eff, bn, bk)), all contiguous."""
    bm, bn, bk = block
    G, M, K = x.shape
    N = w.shape[2]
    bm_eff, Mp = _row_tile(M, bm)
    Kp = _round_up(K, min(bk, K))
    Np = _round_up(N, min(bn, N))
    x = F.pad(x, (0, Kp - K, 0, Mp - M)) if (Mp, Kp) != (M, K) else x
    if (Kp, Np) != (K, N):
        w = F.pad(w, (0, Np - N, 0, Kp - K))
        masks = [F.pad(m, (0, Np - N, 0, Kp - K)) for m in masks]
    return (x.contiguous(), w.contiguous(), [m.contiguous() for m in masks],
            (bm_eff, min(bn, Np), min(bk, Kp)))


def grouped_masked_linear(x, w, mask, *, block=(128, 128, 128)):
    """out[g] = x[g] @ (w[g] * mask[g]) for every group, ONE launch (K16),
    the mask fused into the kernel (any pattern; w * m never written to
    device memory).  x: (G, M, K); w, mask: (G, K, N) -> (G, M, N).  M is
    padded to the row tile and K/N to their clamped tiles (zeros), as in
    ``masked_linear``.  Differentiable: dx (K17) and dw (K18) on the same
    mask."""
    M, N = x.shape[1], w.shape[2]
    x, w, (mask,), blk = _grouped_masked_operands(x, w, [mask], block)
    out = GroupedMaskedMatmul.apply(x, w, mask, *blk)
    return out[:, :M, :N]


def topkast_grouped_masked_linear(x, w, mask, bwd_mask, *, block=(128, 128, 128)):
    """``grouped_masked_linear`` with the Top-KAST split: forward (K16) and
    dx (K17) on ``mask`` (A), the weight gradient (K18) on ``bwd_mask``
    (B ⊇ A); padding as in ``grouped_masked_linear``."""
    M, N = x.shape[1], w.shape[2]
    x, w, (mask, bwd_mask), blk = _grouped_masked_operands(x, w, [mask, bwd_mask],
                                                           block)
    out = TopkastGroupedMaskedMatmul.apply(x, w, mask, bwd_mask, *blk)
    return out[:, :M, :N]


def fused_grouped_masked_linear(x, w, mask, mom, seed: int, *, mu: float, wd: float,
                                sr: bool, bwd_mask=None, block=(128, 128, 128)):
    """``grouped_masked_linear`` whose weight cotangent is the new SGD
    momentum ``(mu * mom + x^T g + wd * w) * wgrad_mask`` per group (K20),
    wgrad_mask ``bwd_mask`` (the Top-KAST superset) when given, else
    ``mask``; padding as in ``grouped_masked_linear`` (mom rides w's zero
    padding; the sr ids are those of the padded (G, Kp, Np) bank, as the
    reference's)."""
    M, N = x.shape[1], w.shape[2]
    wgm = mask if bwd_mask is None else bwd_mask
    x, w, (mask, wgm, mom), blk = _grouped_masked_operands(x, w, [mask, wgm, mom], block)
    out = FusedGroupedMaskedMatmul.apply(x, w, mask, wgm, mom, seed, mu, wd, sr, *blk)
    return out[:, :M, :N]


def topk_threshold(x, k: int, *, refine: bool = True, histogram=histogram_abs):
    """Threshold t with |{i: |x_i| >= t}| ~= k from a streaming histogram
    of |x| (K21), op by op in f32 as the reference's ``ops.topk_threshold``:
    one pass, and with ``refine`` one more over the bracketing bin, so 2
    ``histogram`` calls (1 without).  A 0-d f32 tensor on x's device; no
    host sync.  ``histogram`` swaps in another histogram of the same
    contract (``topk_threshold.histogram_abs_plain``, to hold the kernel's
    path against the plain one on the card).

    The refinement is reproduced as the reference has it, not improved:
    every element outside the bracketing bin is replaced by the sentinel
    ``2 * hi`` and so counted in the second histogram's top bin, which then
    almost always holds ``need`` already: the refined threshold is about
    the bracketing bin's upper edge (ROADMAP.md §C)."""
    a = x.reshape(-1).float().abs()
    hi = a.max() + 1e-12
    width = hi / N_BINS
    hist = histogram(x, hi)[0]
    # cumulative count from the top bin down; the first bin where it is >= k
    desc = torch.cumsum(hist.flip(0), 0)
    bin_from_top = torch.argmax((desc >= k).to(torch.uint8))
    lo_edge = (N_BINS - 1 - bin_from_top).to(torch.float32) * width
    if not refine:
        return lo_edge
    upper = lo_edge + width
    in_above = (a >= upper).sum()
    sub = torch.where((a >= lo_edge) & (a < upper), a - lo_edge, -1.0)
    hist2 = histogram(torch.where(sub >= 0, sub, 2 * hi), width)[0]
    need = k - in_above
    desc2 = torch.cumsum(hist2.flip(0), 0)
    b2 = torch.argmax((desc2 >= need).to(torch.uint8))
    return lo_edge + (N_BINS - 1 - b2).to(torch.float32) * (width / N_BINS)
