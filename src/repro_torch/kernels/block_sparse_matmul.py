"""Block-sparse matmul y = x @ W over W's active (bk, bn) blocks, forward
and backward.

Replaces three TPU kernels of ``repro/kernels/block_sparse_matmul.py`` with
hand-written CUDA kernels for Hopper (sm_90a); the designs and their traps
are described in the sources:

  K1 ``_fwd_kernel`` (``_fwd_call``)  y = x @ W over the CSC pack
     ``idx[j, :cnt[j]]``                       -> csrc/block_sparse_fwd.cu
                                                (on the GEMM core, gemm_core.cuh)
  K2 ``_dx_kernel`` (``_dx_call``)    dx = g @ W^T over the CSR pack
     ``ridx[k, :rcnt[k]]``                     -> csrc/block_sparse_bwd.cu
                                                (on the GEMM core, gemm_core.cuh)
  K3 ``_dw_kernel`` (``_dw_call``)    dw = x^T @ g on the active blocks of
     a CSC pack, zeros elsewhere               -> csrc/block_sparse_bwd.cu
                                                (on the GEMM core, gemm_core.cuh)
  K4 ``_g_fwd_kernel`` (``_g_fwd_call``)  y[g] = x[g] @ W[g] for every group
     of a (G, K, N) weight bank over the stacked CSC ``idx[g, j, :cnt[g, j]]``
     (the MoE experts), one launch            -> csrc/block_sparse_grouped.cu
                                                (K1's kernel, block_sparse_fwd.cuh,
                                                on the GEMM core)
  K5 ``_g_dx_kernel`` (``_g_dx_call``)  dx[g] = g[g] @ W[g]^T over the
     stacked CSR ``ridx[g, k, :rcnt[g, k]]``   -> csrc/block_sparse_grouped.cu
  K6 ``_g_dw_kernel`` (``_g_dw_call``)  dw[g] = x[g]^T @ g[g] on the active
     blocks of a stacked CSC, zeros elsewhere  -> csrc/block_sparse_grouped.cu
                                                (K2/K3's kernels, block_sparse_bwd.cuh,
                                                on the GEMM core)
  K7 ``_dw_fused_kernel`` (``_dw_fused_call``)  K3 whose blocks store the
     new SGD momentum mu * mom + x^T @ g + wd * w, optionally stochastically
     rounded onto the bf16 grid                -> csrc/block_sparse_bwd.cu
  K8 ``_g_dw_fused_kernel`` (``_g_dw_fused_call``)  K7 per group of a bank
                                               -> csrc/block_sparse_grouped.cu
                                                (K3/K6's kernel with the momentum
                                                epilogue policy, epilogue.cuh)

Each runs in bf16 (tensor cores) and in f32 (the reference's MLP computes
in the f32 residual's dtype), accumulating in f32 and rounding once to the
element type.  K1-K6 run on the GEMM core of the masked kernels (mma.sync
bf16, and 3xTF32 for f32) with its split rule (``masked_matmul.fwd_split``,
on the pack's live blocks), each with its plan here.  K3/K6 (``dw_plan``):
one CTA a live block, the M walk split where the live blocks leave the
card's last wave mostly idle, the split's packed f32 partials summed in
order by ``bs_dw_merge``.  K1/K4 (``fwd_plan``): one CTA a (column tile,
row tile) of y, walking its block column's packed list of active K-blocks,
the list split where the grid leaves the card's slots empty (decode) or
its last wave idle, the f32 partials summed in order by ``bs_fwd_merge``.
K2/K5 (``dx_plan``): the same walk over each K-block row's CSR list of
active N-blocks, one CTA a (row tile, column tile) of dx, the f32
partials of a split summed in order by ``bs_dx_merge``.  K7/K8 are K3/K6's
kernel with the momentum epilogue at the store (``dw_plan`` on the fused
kernel's own resident CTAs), a split's unfused partials summed in order by
``bs_dw_fused_merge``, which then folds the momentum, applies sr and
rounds once.

The plain versions select the pack's blocks (``torch.where``), never
multiply by the expanded mask, and sum each product over the pack's active
blocks only: an inf or NaN weight in an inactive block, an inf or NaN in x
(K1, K4) or g (K2, K5) that only inactive blocks read, or a wgrad sum off
the pack, never reaches the output, and dw is +0.0 off the pack, as the
reference (whose kernels never read an inactive block, and whose
``_scatter_packed_dw`` writes the blocks into zeros).

Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s f32
FFMA): each kernel must at least read the active weight (or gradient)
blocks and its dense operands once; decode rows are few, so K1 is bound by
bytes there, and the training shapes (M = 2048) sit below the bf16 ridge.

Every wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (``*_plain``) only for CPU tensors.  ``launches``,
``dx_launches``, ``dw_launches``, ``g_launches``, ``gdx_launches``,
``gdw_launches``, ``fused_launches`` and ``g_fused_launches`` count kernel
launches, so a run can show that its path went through the kernels;
``fwd_merge_launches`` counts the split merges after K1 and K4,
``dx_merge_launches`` those after K2 and K5, ``dw_merge_launches`` those
after K3 and K6, ``dw_fused_merge_launches`` those after K7 and K8.
``BlockSparseMatmul``, ``TopkastBlockSparseMatmul``,
``GroupedBlockSparseMatmul`` and ``TopkastGroupedBlockSparseMatmul`` are the
differentiable forms (the reference's custom VJPs ``_bs_fwd/_bs_bwd``,
``_tk_fwd/_tk_bwd``, ``_gbs_fwd/_gbs_bwd`` and ``_gtk_fwd/_gtk_bwd``); the
two Top-KAST forms given a momentum are also the reference's fused
``_fbs_fwd/_fbs_bwd`` and ``_gfbs_fwd/_gfbs_bwd``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .opaque import opaque

__all__ = [
    "BlockSparseMatmul",
    "GroupedBlockSparseMatmul",
    "TopkastBlockSparseMatmul",
    "TopkastGroupedBlockSparseMatmul",
    "block_sparse_dw",
    "block_sparse_dw_fused",
    "block_sparse_dw_fused_plain",
    "block_sparse_dw_fused_split_plain",
    "block_sparse_dw_plain",
    "block_sparse_dw_split_plain",
    "bs_dw_fused_merge",
    "bs_dw_fused_merge_plain",
    "bs_dw_merge",
    "bs_dw_merge_plain",
    "block_sparse_dx",
    "block_sparse_dx_plain",
    "block_sparse_dx_split_plain",
    "bs_dx_merge",
    "block_sparse_matmul",
    "block_sparse_matmul_plain",
    "block_sparse_matmul_split_plain",
    "bs_fwd_merge",
    "csr_of",
    "dw_candidates",
    "dw_fused_merge_launches",
    "dw_launch_info",
    "dw_launches",
    "dw_merge_launches",
    "dw_plan",
    "dw_tile",
    "dx_candidates",
    "dx_launch_info",
    "dx_launches",
    "dx_merge_launches",
    "dx_plan",
    "fused_launches",
    "fwd_candidates",
    "fwd_launch_info",
    "fwd_merge_launches",
    "fwd_plan",
    "g_fused_launches",
    "g_launches",
    "gdw_launches",
    "gdx_launches",
    "grouped_block_sparse_dw",
    "grouped_block_sparse_dw_fused",
    "grouped_block_sparse_dw_fused_plain",
    "grouped_block_sparse_dw_plain",
    "grouped_block_sparse_dx",
    "grouped_block_sparse_dx_plain",
    "grouped_block_sparse_matmul",
    "grouped_block_sparse_matmul_plain",
    "launches",
    "matmul_error_bound",
    "unpack_block_mask",
    "upcast",
]

# kernel launches since import (or since a caller reset them)
launches = 0     # K1
dx_launches = 0  # K2
dw_launches = 0  # K3
g_launches = 0   # K4
gdx_launches = 0  # K5
gdw_launches = 0  # K6
fused_launches = 0    # K7
g_fused_launches = 0  # K8
dw_merge_launches = 0  # the merges of split K3 and K6 launches
fwd_merge_launches = 0  # the merges of split K1 and K4 launches
dx_merge_launches = 0  # the merges of split K2 and K5 launches
dw_fused_merge_launches = 0  # the merges of split K7 and K8 launches

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_P = ctypes.c_void_p
_I = ctypes.c_int
# a fused-epilogue entry's trailing arguments: seed, mu, wd, sr
_FUSED_TAIL = (ctypes.c_uint32, ctypes.c_float, ctypes.c_float, _I)


def unpack_block_mask(idx: torch.Tensor, cnt: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """CSC ``(idx, cnt)`` -> (n_rows, n_cols) bool block mask, without a
    host sync: padded slots scatter into a dummy trailing row.  A stacked
    grouped pack (``idx (G, n_cols, width)``) gives (G, n_rows, n_cols)."""
    *lead, n_cols, width = idx.shape
    live = torch.arange(width, device=idx.device) < cnt[..., None]
    rows = torch.where(live, idx.long(), n_rows)
    bm = torch.zeros(*lead, n_cols, n_rows + 1, dtype=torch.bool, device=idx.device)
    bm.scatter_(-1, rows, True)
    return bm[..., :n_rows].transpose(-1, -2).contiguous()


def csr_of(idx: torch.Tensor, cnt: torch.Tensor, n_rows: int):
    """CSC ``(idx, cnt)`` -> CSR ``(ridx, rcnt)`` at the worst-case width
    (all N-blocks), ids ascending, padded slots 0: the reference's traced
    fallback when a bare CSC tuple comes without its CSR view.  A stacked
    grouped pack gives the stacked CSR ``(G, n_rows, N/bn)``, ``(G,
    n_rows)``."""
    bm = unpack_block_mask(idx, cnt, n_rows)
    rcnt = bm.sum(-1).to(torch.int32)
    order = torch.argsort((~bm).to(torch.uint8), dim=-1, stable=True)
    live = torch.arange(bm.shape[-1], device=bm.device) < rcnt[..., None]
    return torch.where(live, order, 0).to(torch.int32).contiguous(), rcnt


def _dense_mask(idx, cnt, n_rows: int, bk: int, bn: int) -> torch.Tensor:
    return _expand(unpack_block_mask(idx, cnt, n_rows), bk, bn)


def _on_blocks(a, b, live, rb: int, cb: int):
    """``a (..., R, L) @ b (..., L, C)`` in f32, summed over b's live (rb,
    cb) blocks only: ``live (..., L/rb, C/cb)`` bool, b zero off them.  The
    dense product, except that the rows of a that hold an inf or NaN are
    summed block by block (a batched product over each group that has
    them), so that such a value reaches only the outputs whose blocks read
    it: the dense product would meet an inactive block's zero with it and
    give NaN, where the reference's kernels never read that block."""
    af, bf = a.float(), b.float()
    out = af @ bf
    bad = ~torch.isfinite(af).all(-1)
    if not bool(bad.any()):
        return out
    a3, b3, o3, l3, bad3 = (t if a.dim() == 3 else t[None] for t in (af, bf, out, live, bad))
    nl = a3.shape[-1] // rb
    for g in bad3.any(-1).nonzero().flatten().tolist():
        rows = bad3[g].nonzero().flatten()
        part = torch.bmm(a3[g, rows].unflatten(-1, (nl, rb)).transpose(0, 1),
                         b3[g].unflatten(0, (nl, rb)))  # (L/rb, rows, C)
        keep = l3[g].repeat_interleave(cb, -1)[:, None, :]
        o3[g, rows] = torch.where(keep, part, 0.0).sum(0)
    return out


def _expand(live, rb: int, cb: int):
    return live.repeat_interleave(rb, -2).repeat_interleave(cb, -1)


def block_sparse_matmul_plain(x, w, idx, cnt, bk: int, bn: int):
    """Plain K1: select w onto the pack's blocks and compute ``x @
    w_selected`` over the active blocks only (``_on_blocks``), with f32
    accumulation, rounded once to x.dtype."""
    live = unpack_block_mask(idx, cnt, w.shape[0] // bk)
    wsel = torch.where(_expand(live, bk, bn), w.float(), 0.0)
    return _on_blocks(x, wsel, live, bk, bn).to(x.dtype)


def grouped_block_sparse_matmul_plain(x, w, idx, cnt, bk: int, bn: int):
    """Plain K4: per group ``x[g] @ w[g]`` selected onto the stacked CSC's
    blocks, summed over the active blocks only, with f32 accumulation,
    rounded once to x.dtype; a group whose counts are all zero (a dead
    expert) gives zeros."""
    live = unpack_block_mask(idx, cnt, w.shape[-2] // bk)
    wsel = torch.where(_expand(live, bk, bn), w.float(), 0.0)
    return _on_blocks(x, wsel, live, bk, bn).to(x.dtype)


def grouped_block_sparse_dx_plain(g, w, ridx, rcnt, bk: int, bn: int):
    """Plain K5: per group ``g[g] @ w[g]^T`` with w selected onto the
    stacked CSR's blocks, summed over the active blocks only, in f32,
    rounded once to g.dtype; a dead expert's rows are zeros."""
    live = unpack_block_mask(ridx, rcnt, w.shape[-1] // bn)  # (G, N/bn, K/bk)
    wsel_t = torch.where(_expand(live, bn, bk), w.float().transpose(1, 2), 0.0)
    return _on_blocks(g, wsel_t, live, bn, bk).to(g.dtype)


def grouped_block_sparse_dw_plain(x, g, idx, cnt, bk: int, bn: int):
    """Plain K6: per group ``x[g]^T @ g[g]`` in f32 selected onto the
    stacked CSC's blocks, +0.0 elsewhere, rounded once to x.dtype (the
    reference's packed slots scattered by ``_scatter_packed_dw``)."""
    mask = _dense_mask(idx, cnt, x.shape[-1] // bk, bk, bn)
    return torch.where(mask, torch.bmm(x.float().transpose(1, 2), g.float()), 0.0).to(x.dtype)


def block_sparse_dx_plain(g, w, ridx, rcnt, bk: int, bn: int):
    """Plain K2: ``g @ w^T`` with w selected onto the CSR pack's blocks,
    summed over the active blocks only, in f32, rounded once to g.dtype."""
    live = unpack_block_mask(ridx, rcnt, w.shape[1] // bn)  # (N/bn, K/bk)
    wsel_t = torch.where(_expand(live, bn, bk), w.float().T, 0.0)
    return _on_blocks(g, wsel_t, live, bn, bk).to(g.dtype)


def block_sparse_dw_plain(x, g, idx, cnt, bk: int, bn: int):
    """Plain K3: ``x^T @ g`` in f32 selected onto the CSC pack's blocks,
    +0.0 elsewhere, rounded once to x.dtype."""
    mask = _dense_mask(idx, cnt, x.shape[1] // bk, bk, bn)
    return torch.where(mask, x.float().T @ g.float(), 0.0).to(x.dtype)


def block_sparse_dw_split_plain(x, g, idx, cnt, bk: int, bn: int, n_split: int):
    """K3 (x (M, K), g (M, N), a CSC pack) or K6 (every operand with a
    leading group dim) as a split launch computes it: split s's f32 partial
    ``x^T @ g`` over M's slabs ``fwd_split_ranges(M, n_split)[s]``, the
    partials summed in the order s = 0, 1, ..., selected onto the pack's
    blocks (+0.0 elsewhere) and rounded once to x.dtype."""
    from .masked_matmul import _split_xtg  # masked_matmul imports this module

    mask = _dense_mask(idx, cnt, x.shape[-1] // bk, bk, bn)
    return torch.where(mask, _split_xtg(x, g, n_split), 0.0).to(x.dtype)


def block_sparse_matmul_split_plain(x, w, idx, cnt, bk: int, bn: int, n_split: int):
    """K1 (x (M, K), w (K, N), a CSC pack) or K4 (every operand with a
    leading group dim) as a split launch computes it: column j's walk is
    the n = cnt[j] * spb slabs of its list ``idx[j, :cnt[j]]`` (in the
    list's order; spb = ceil(bk / FWD_SLAB) slabs a block, each ending at
    most where its block does), split s takes slabs [s n // n_split, (s + 1)
    n // n_split) and its f32 partial is x's product with the w rows of
    those slabs over them only (``_on_blocks``); the partials are summed in
    the order s = 0, 1, ... and rounded once to x.dtype."""
    from .masked_matmul import FWD_SLAB  # masked_matmul imports this module

    x3, w3, ix, cn = (x, w, idx, cnt) if x.dim() == 3 else (x[None], w[None], idx[None],
                                                             cnt[None])
    G, (K, N), width = x3.shape[0], w3.shape[-2:], ix.shape[-1]
    nkb, nnb, spb = K // bk, N // bn, -(-bk // FWD_SLAB)
    rb = math.gcd(bk, FWD_SLAB)  # rows on which a slab's split is constant
    # pos[g, j, k]: block k's place in column j's list, -1 where inactive
    slot = torch.arange(width, device=ix.device)
    on = slot < cn[..., None]
    pos = torch.full((G, nnb, nkb + 1), -1, dtype=torch.long, device=ix.device)
    pos.scatter_(-1, torch.where(on, ix.long(), nkb), slot.expand_as(ix).clone())
    pos = pos[..., :nkb].transpose(1, 2)  # (G, K/bk, N/bn)
    # each rb-row piece's slab in its column's walk, and that slab's split
    sub = (torch.arange(K // rb, device=ix.device) * rb % bk) // FWD_SLAB
    t = pos.repeat_interleave(bk // rb, 1) * spb + sub[None, :, None]  # (G, K/rb, N/bn)
    n = (cn.long() * spb)[:, None, :]
    split = sum((t >= (s * n) // n_split).long() for s in range(1, n_split))
    live = pos.repeat_interleave(bk // rb, 1) >= 0
    wf = w3.float()
    acc = None
    for s in range(n_split):
        piece = live & (split == s)
        part = _on_blocks(x3, torch.where(_expand(piece, rb, bn), wf, 0.0), piece, rb, bn)
        acc = part if acc is None else acc + part
    return acc.to(x.dtype) if x.dim() == 3 else acc[0].to(x.dtype)


def block_sparse_dx_split_plain(g, w, ridx, rcnt, bk: int, bn: int, n_split: int):
    """K2 (g (M, N), w (K, N), a CSR pack) or K5 (every operand with a
    leading group dim) as a split launch computes it: the forward's split
    walk (``block_sparse_matmul_split_plain``) on g and w^T, whose CSC over
    its K-block columns is w's CSR.  K-block row kb's walk is the n =
    rcnt[kb] * ceil(bn / FWD_SLAB) slabs of its list ``ridx[kb,
    :rcnt[kb]]``, in the list's order; split s takes slabs [s n // n_split,
    (s + 1) n // n_split) and its f32 partial is g's product with those
    slabs of w^T; the partials are summed in the order s = 0, 1, ... and
    rounded once to g.dtype."""
    return block_sparse_matmul_split_plain(g, w.transpose(-1, -2), ridx, rcnt, bn, bk, n_split)


def bs_dw_merge_plain(part, idx, cnt, dw):
    """The split merge of K3/K6 on the packed partials: part (n_split, G,
    N/bn, width, bk, bn) f32, the stacked CSC ``idx``/``cnt`` and dw (G, K,
    N) (or a 2-D pack and dw with G = 1).  Each live slot's partials are
    summed in the order s = 0, 1, ..., rounded once to dw.dtype and written
    into the block's place in dw, in place; padded slots are neither read
    nor written, so dw keeps whatever it held off the pack.  Returns dw."""
    bk, bn = part.shape[-2:]
    d, ix, cn = (dw, idx, cnt) if dw.dim() == 3 else (dw[None], idx[None], cnt[None])
    acc = part[0].clone()
    for s in range(1, part.shape[0]):
        acc += part[s]
    live = torch.arange(ix.shape[-1], device=ix.device) < cn[..., None]
    grp, j, s = live.nonzero(as_tuple=True)
    rows = (ix[grp, j, s].long() * bk)[:, None] + torch.arange(bk, device=ix.device)
    cols = (j * bn)[:, None] + torch.arange(bn, device=ix.device)
    d[grp[:, None, None], rows[:, :, None], cols[:, None, :]] = acc[grp, j, s].to(d.dtype)
    return dw


def _fused_plain(acc, idx, cnt, w, mom, seed, mu, wd, sr, bk, bn, out_dtype):
    """The fused epilogue on a wgrad sum ``acc`` (f32, w's shape): m_new =
    mu * mom + acc + wd * w in f32, left to right, on the pack's blocks and
    exactly zero elsewhere (the kernels never store there); ``sr`` rounds it
    with the element ids (g * K + row) * N + col; rounded once to
    ``out_dtype`` (default w.dtype)."""
    from .masked_matmul import _gid, sr_to_bf16  # masked_matmul imports this module

    live = _dense_mask(idx, cnt, w.shape[-2] // bk, bk, bn)
    m_new = torch.where(live, mu * mom.float() + acc + wd * w.float(), 0.0)
    if sr:
        K, N = w.shape[-2:]
        m_new = sr_to_bf16(m_new, seed, _gid(K, N, m_new.device,
                                             G=w.shape[0] if w.dim() == 3 else None))
    return m_new.to(out_dtype or w.dtype)


def block_sparse_dw_fused_plain(x, g, idx, cnt, w, mom, seed: int, *, mu: float,
                                wd: float, sr: bool, bk: int, bn: int, out_dtype=None):
    """Plain K7: the plain dw on the CSC pack's blocks, then the fused SGD
    epilogue (``_fused_plain``): the new momentum (K, N)."""
    acc = x.float().T @ g.float()
    return _fused_plain(acc, idx, cnt, w, mom, seed, mu, wd, sr, bk, bn, out_dtype)


def grouped_block_sparse_dw_fused_plain(x, g, idx, cnt, w, mom, seed: int, *, mu: float,
                                        wd: float, sr: bool, bk: int, bn: int,
                                        out_dtype=None):
    """Plain K8: per group the plain dw on the stacked CSC's blocks, then
    the fused SGD epilogue with the bank's element ids: the new momentum
    (G, K, N); a group with no block gives zeros."""
    acc = torch.bmm(x.float().transpose(1, 2), g.float())
    return _fused_plain(acc, idx, cnt, w, mom, seed, mu, wd, sr, bk, bn, out_dtype)


def block_sparse_dw_fused_split_plain(x, g, idx, cnt, w, mom, seed: int, n_split: int, *,
                                      mu: float, wd: float, sr: bool, bk: int, bn: int,
                                      out_dtype=None):
    """K7 (x (M, K), g (M, N), w and mom (K, N), a CSC pack) or K8 (every
    operand with a leading group dim) as a split launch computes it: split
    s's f32 partial ``x^T @ g`` over M's slabs ``fwd_split_ranges(M,
    n_split)[s]``, the partials summed in the order s = 0, 1, ..., then the
    fused epilogue once on the pack's blocks (``_fused_plain``: the
    momentum, sr, one rounding), exactly zero elsewhere; at n_split = 1 bit
    for bit the unsplit plain version."""
    from .masked_matmul import _split_xtg  # masked_matmul imports this module

    return _fused_plain(_split_xtg(x, g, n_split), idx, cnt, w, mom, seed, mu, wd, sr, bk, bn,
                        out_dtype)


def bs_dw_fused_merge_plain(part, idx, cnt, w, mom, out, seed: int, *, mu: float, wd: float,
                            sr: bool):
    """The split merge of K7/K8 on the packed partials: part (n_split, G,
    N/bn, width, bk, bn) f32, the stacked CSC ``idx``/``cnt``, w, mom and
    out (G, K, N) (or a 2-D pack and (K, N) with G = 1).  Each live slot's
    partials are summed in the order s = 0, 1, ..., then the fused epilogue
    (``_fused_plain``: mu * mom + sum + wd * w, sr on the element ids of
    out's shape), rounded once to out.dtype and written into the block's
    place in out, in place; padded slots are neither read nor written, so
    out keeps whatever it held off the pack.  Returns out."""
    bk, bn = part.shape[-2:]
    acc = bs_dw_merge_plain(part, idx, cnt, torch.zeros(out.shape, device=out.device))
    live = _dense_mask(idx, cnt, out.shape[-2] // bk, bk, bn)
    m_new = _fused_plain(acc, idx, cnt, w, mom, seed, mu, wd, sr, bk, bn, out.dtype)
    out[live] = m_new[live]
    return out


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


def _fused_entry_name(what, s, shape, x, w, mom, out_dtype):
    """Checks of a fused-epilogue launch beyond ``_check_cuda``'s (w like x,
    mom bf16 or f32, both of the output's ``shape`` on x's device,
    contiguous and 16-byte aligned; an f32 entry has only an f32 output)
    -> the entry suffix ``<T>_<mom type>_<output type>``."""
    if tuple(w.shape) != shape or tuple(mom.shape) != shape or \
            w.device != x.device or mom.device != x.device:
        raise ValueError(f"{what}: w {tuple(w.shape)} / mom {tuple(mom.shape)} on "
                         f"{mom.device} do not match {shape} on {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: w must be {x.dtype} like x and g (got {w.dtype})")
    if mom.dtype not in _SUFFIX or not (w.is_contiguous() and mom.is_contiguous()) \
            or w.data_ptr() % 16 or mom.data_ptr() % 16:
        raise TypeError(f"{what}: mom must be contiguous bf16 or f32 and w contiguous "
                        f"(got mom {mom.dtype})")
    if out_dtype not in _SUFFIX or (s == "f32" and out_dtype != torch.float32):
        raise TypeError(f"{what}: no {s} entry with {out_dtype} output")
    return f"{s}_{_SUFFIX[mom.dtype]}_{_SUFFIX[out_dtype]}"


def _entry(lib_name: str, fn_name: str, n_ptr: int, n_int: int, tail=()):
    """The C entry ``fn_name``: ``n_ptr`` pointers, ``n_int`` ints, the
    ``tail`` types, then the stream."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + list(tail) + [_P]
    fn.restype = _I
    return lib, fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_grid(Mp, K, N, G, dtype, bk, bn, live):
    """K1/K4's grid at one launch: (tile rows, tile columns, CTAs, merged
    f32 elements of a split, the mean slabs a column's list walks, the
    decode split's cap).  Each of the G N/bn block columns has its own list,
    so its ceil(bn / tile columns) column tiles are its own (a tile never
    spans two block columns); a column walks live ceil(bk / FWD_SLAB) / (G
    N/bn) slabs on the mean; the partials stay within a quarter of the live
    blocks' bytes (live bk bn e)."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    tm, tn = mm.fwd_tile(Mp, bn)
    n_cols = G * (N // bn)
    tiles = -(-Mp // tm) * -(-bn // tn) * n_cols
    n_slabs = live * -(-bk // mm.FWD_SLAB) // max(n_cols, 1)
    cap = live * bk * bn * dtype.itemsize // (32 * G * Mp * N)
    return tm, tn, tiles, G * Mp * N, n_slabs, cap


def fwd_plan(Mp: int, K: int, N: int, G: int, dtype, slots: int, *, bk: int, bn: int,
             live: int) -> tuple[int, int, int]:
    """K1/K4's launch of x (G, Mp, K) @ w (G, K, N) (G = 1 for K1) on
    ``live`` active (bk, bn) blocks (the forward pack's nnz) -> (tile rows,
    tile columns, n_split): the masked forward's tile (``fwd_tile`` at bn:
    16 x 64 at decode, 128 x 64 for blocks under 128 columns, else 128 x
    128) and ``masked_matmul.fwd_split`` on ``_fwd_grid``, weighing every
    split at 128 rows (the walks are a column's few blocks).  ``slots``:
    the CTAs the card holds at once at the tile."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    tm, tn, tiles, cells, n_slabs, cap = _fwd_grid(Mp, K, N, G, dtype, bk, bn, live)
    return tm, tn, mm.fwd_split(tm, tn, tiles, cells, n_slabs, cap, dtype, slots, every=True)


def fwd_candidates(Mp: int, K: int, N: int, G: int, dtype, slots: int, *, bk: int, bn: int,
                   live: int) -> list[tuple[int, int, int]]:
    """The plans a sweep forces at one K1/K4 shape (``fwd_plan``'s
    arguments): every built tile of the pick's rows no wider than
    max(bn, 64), each with every split of
    ``masked_matmul.fwd_split_candidates``, and ``fwd_plan``'s pick."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    tm, _, _, _, n_slabs, cap = _fwd_grid(Mp, K, N, G, dtype, bk, bn, live)
    out = [(a, b, n) for a, b in mm.FWD_TILES if a == tm and b <= max(bn, 64)
           for n in mm.fwd_split_candidates(tm, n_slabs, cap, every=True)]
    pick = fwd_plan(Mp, K, N, G, dtype, slots, bk=bk, bn=bn, live=live)
    return out if pick in out else out + [pick]


def fwd_launch_info(dtype, tm: int, tn: int, width: int) -> dict:
    """``masked_matmul.launch_info`` of K1/K4's kernel at tile (tm, tn) in
    ``dtype`` with a list of ``width`` block ids in shared memory.  Needs a
    card."""
    from .masked_matmul import launch_info  # masked_matmul imports this module

    return launch_info(f"block_sparse_fwd_info_{_SUFFIX[dtype]}", "block_sparse_fwd", tm, tn,
                       width)


@functools.lru_cache(maxsize=4096)
def _fwd_plan_for(Mp, K, N, G, dtype, bk, bn, live, device_index):
    """``fwd_plan`` with the card's slots (SMs times the resident CTAs of
    K1/K4's kernel at the tile with the longest list a column of K/bk
    blocks can hold, from the runtime), memoized."""
    from .masked_matmul import fwd_tile  # masked_matmul imports this module

    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    slots = sms * fwd_launch_info(dtype, *fwd_tile(Mp, bn), K // bk)["ctas_per_sm"]
    return fwd_plan(Mp, K, N, G, dtype, slots, bk=bk, bn=bn, live=live)


def dx_plan(Mp: int, K: int, N: int, G: int, dtype, slots: int, *, bk: int, bn: int,
            live: int) -> tuple[int, int, int]:
    """K2/K5's launch of g (G, Mp, N) @ w (G, K, N)^T (G = 1 for K2) on
    ``live`` active (bk, bn) blocks (the forward pack's nnz: the CSR lists
    the same blocks) -> (tile rows, tile columns, n_split).  The dgrad is
    the forward's packed walk with the dims' roles swapped: rows Mp, the
    contraction N visited in the active bn-wide N-blocks of each K-block
    row's list, columns K in block rows of bk.  So ``fwd_plan`` on (Mp, N,
    K) with the blocks (bn, bk): the tile ``fwd_tile(Mp, bk)``, ceil(Mp /
    tm) ceil(bk / tn) G K/bk CTAs, a row's mean walk of live ceil(bn / 32) /
    (G K/bk) slabs, and ``fwd_split``'s split of it."""
    return fwd_plan(Mp, N, K, G, dtype, slots, bk=bn, bn=bk, live=live)


def dx_candidates(Mp: int, K: int, N: int, G: int, dtype, slots: int, *, bk: int, bn: int,
                  live: int) -> list[tuple[int, int, int]]:
    """The plans a sweep forces at one K2/K5 shape (``dx_plan``'s
    arguments): ``fwd_candidates`` with the dims' roles swapped, as
    ``dx_plan``."""
    return fwd_candidates(Mp, N, K, G, dtype, slots, bk=bn, bn=bk, live=live)


def dx_launch_info(dtype, tm: int, tn: int, width: int) -> dict:
    """``masked_matmul.launch_info`` of K2/K5's kernel at tile (tm, tn) in
    ``dtype`` with a list of ``width`` block ids in shared memory.  Needs a
    card."""
    from .masked_matmul import launch_info  # masked_matmul imports this module

    return launch_info(f"block_sparse_dx_info_{_SUFFIX[dtype]}", "block_sparse_bwd", tm, tn,
                       width)


@functools.lru_cache(maxsize=4096)
def _dx_plan_for(Mp, K, N, G, dtype, bk, bn, live, device_index):
    """``dx_plan`` with the card's slots (SMs times the resident CTAs of
    K2/K5's kernel at the tile with the longest list a row of N/bn blocks
    can hold, from the runtime), memoized."""
    from .masked_matmul import fwd_tile  # masked_matmul imports this module

    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    slots = sms * dx_launch_info(dtype, *fwd_tile(Mp, bk), N // bn)["ctas_per_sm"]
    return dx_plan(Mp, K, N, G, dtype, slots, bk=bk, bn=bn, live=live)


def dw_tile(bn: int) -> tuple[int, int]:
    """K3/K6's CTA tile: the smallest built wgrad tile
    (``masked_matmul.DW_TILES``) that holds a block of ``bn`` columns, 128
    x 64 for blocks at most 64 wide, else 128 x 128 (its rows, 128, hold
    any bk)."""
    return 128, 64 if bn <= 64 else 128


def dw_plan(M: int, K: int, N: int, G: int, dtype, slots: int, *, bn: int,
            live: int | None = None) -> tuple[int, int, int]:
    """K3/K6's launch of x (G, M, K)^T @ g (G, M, N) -> dw (G, K, N) (G = 1
    for K3) on ``live`` blocks of ``bn`` columns (the wgrad pack's: the
    pack entry's bnnz for a superset, else its nnz; None: every tile of the
    (K, N) grid) -> (tile rows, tile columns, n_split).  One CTA a live
    block in ``dw_tile``; the n = ceil(M / FWD_SLAB) slabs of the M walk may
    be split in whole-slab parts whose packed f32 partials ``bs_dw_merge``
    sums (8 bytes a split for each of the live tiles' elements);
    ``masked_matmul.fwd_split`` weighs every split: the grid is the pack's
    live blocks, a few dozen to a few hundred (danube's wk at 63 live
    blocks and its f32 MLP at 289 were fastest split in 4 on an H100,
    PERF.md).  ``slots``: the CTAs the card holds at once at the tile (for
    K7/K8, the fused kernel's own: ``_dw_plan_for`` with the mom and output
    types)."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    tm, tn = dw_tile(bn)
    tiles = G * -(-K // tm) * -(-N // tn) if live is None else live
    cells = G * K * N if live is None else live * tm * tn  # merged elements
    # the rows are K, never a decode's: the split has no cap
    return tm, tn, mm.fwd_split(tm, tn, tiles, cells, -(-M // mm.FWD_SLAB), 0, dtype, slots,
                                every=True)


def dw_candidates(M: int, K: int, N: int, G: int, dtype, slots: int, *, bn: int,
                  live: int | None = None) -> list[tuple[int, int, int]]:
    """The plans a sweep forces at one K3/K6 shape (``dw_plan``'s
    arguments): every built wgrad tile that holds the block, each with
    every split of ``masked_matmul.fwd_split_candidates``, and
    ``dw_plan``'s pick."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    splits = mm.fwd_split_candidates(128, -(-M // mm.FWD_SLAB), 0, every=True)
    out = [(tm, tn, n) for tm, tn in mm.DW_TILES if tn >= bn for n in splits]
    pick = dw_plan(M, K, N, G, dtype, slots, bn=bn, live=live)
    return out if pick in out else out + [pick]


def dw_launch_info(dtype, tm: int, tn: int, mom_dtype=None, out_dtype=None) -> dict:
    """``masked_matmul.launch_info`` of K3/K6's kernel at tile (tm, tn) in
    ``dtype``, or with ``mom_dtype`` K7/K8's (the same kernel with the
    momentum epilogue, mom in ``mom_dtype`` and the output in ``out_dtype``,
    default ``dtype``).  Needs a card."""
    from .masked_matmul import launch_info  # masked_matmul imports this module

    s = _SUFFIX[dtype]
    if mom_dtype is None:
        return launch_info(f"block_sparse_dw_info_{s}", "block_sparse_bwd", tm, tn)
    return launch_info(f"block_sparse_dw_fused_info_{s}_{_SUFFIX[mom_dtype]}_"
                       f"{_SUFFIX[out_dtype or dtype]}", "block_sparse_bwd", tm, tn)


@functools.lru_cache(maxsize=4096)
def _dw_plan_for(M, K, N, G, dtype, bn, live, device_index, mom_dtype=None, out_dtype=None):
    """``dw_plan`` with the card's slots (SMs times the resident CTAs of
    K3/K6's kernel at its tile, or with ``mom_dtype`` of K7/K8's
    instantiation, from the runtime), memoized."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    slots = sms * dw_launch_info(dtype, *dw_tile(bn), mom_dtype, out_dtype)["ctas_per_sm"]
    return dw_plan(M, K, N, G, dtype, slots, bn=bn, live=live)


def block_sparse_matmul(x, w, idx, cnt, *, bm: int, bn: int, bk: int, plan=None,
                        live=None):
    """K1: x (M, K) @ block-sparse w (K, N) -> (M, N) in x.dtype.

    M must be a multiple of ``bm``, the caller's row padding
    (``kernels/ops.py`` pads rows); the plan's tile decides the launch.
    ``fwd_plan`` picks it from ``live``, the forward pack's live blocks (a
    host int the caller has: the pack entry's nnz; without one every slot
    N/bn * width counts), or ``plan`` = (bm, bn, n_split) forces one (one of
    ``masked_matmul.FWD_TILES``); a split is merged by ``bs_fwd_merge``.
    CUDA tensors run the kernel or raise; CPU tensors run the plain version.
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
    y = _packed_gemm("block_sparse_matmul", "block_sparse_fwd", f"block_sparse_fwd_{s}", x, w,
                     idx, cnt, 1, bk, bn, plan, live)
    launches += 1
    return y


def grouped_block_sparse_matmul(x, w, idx, cnt, *, bm: int, bn: int, bk: int, plan=None,
                                live=None):
    """K4: x (G, M, K) @ block-sparse w (G, K, N) -> (G, M, N) in x.dtype,
    every group in one launch, over the stacked CSC pack ``idx (G, N/bn,
    width)`` / ``cnt (G, N/bn)``.  M must be a multiple of ``bm``, the
    caller's row padding (``kernels/ops.py`` pads rows); ``plan`` and
    ``live`` (the live blocks of the whole bank) as for
    ``block_sparse_matmul``.  CUDA tensors run
    the kernel or raise; CPU tensors run the plain version."""
    global g_launches
    if x.device.type == "cpu":
        return grouped_block_sparse_matmul_plain(x, w, idx, cnt, bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_block_sparse_matmul: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_block_sparse_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be (G, M, K) and (G, K, N)")
    (G, M, K), N = x.shape, w.shape[2]
    s = _check_cuda("grouped_block_sparse_matmul", x, w, {"idx": idx, "cnt": cnt},
                    {"bm": bm, "bn": bn, "bk": bk},
                    [(M, bm), (K, bk), (N, bn)], [(w.shape[0], G), (w.shape[1], K)])
    if idx.dim() != 3 or idx.shape[:2] != (G, N // bn) or cnt.shape != (G, N // bn):
        raise ValueError(f"grouped_block_sparse_matmul: pack idx {tuple(idx.shape)} / "
                         f"cnt {tuple(cnt.shape)} does not match (G, N/bn) = "
                         f"({G}, {N // bn})")
    y = _packed_gemm("grouped_block_sparse_matmul", "block_sparse_grouped",
                     f"block_sparse_grouped_fwd_{s}", x, w, idx, cnt, G, bk, bn, plan, live)
    g_launches += 1
    return y


def _packed_gemm(what, lib_name, fn_name, a, w, ids, cnt, G, bk, bn, plan, live,
                 dgrad=False):
    """One launch of the packed walk on the plan's tile and split, and the
    merge after a split: K1 (G = 1: a = x (M, K), w (K, N), a 2-D CSC) or
    K4 (a = x (G, M, K), w (G, K, N), a stacked CSC) -> y (M, N) or (G, M,
    N); with ``dgrad`` K2 (a = g (M, N), a 2-D CSR) or K5 (a = g (G, M, N),
    a stacked CSR) -> dx (M, K) or (G, M, K).  The plan counts ``live``
    blocks (every slot when None); no pack count is read on the host."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    M, (K, N), width = a.shape[-2], w.shape[-2:], ids.shape[-1]
    cols = K if dgrad else N
    live = G * (cols // (bk if dgrad else bn)) * width if live is None else int(live)
    plan_for = _dx_plan_for if dgrad else _fwd_plan_for
    tm, tn, n_split = plan or plan_for(M, K, N, G, a.dtype, bk, bn, live, a.device.index)
    if (tm, tn) not in mm.FWD_TILES or not 1 <= n_split <= mm.FWD_MAX_SPLIT:
        raise ValueError(f"{what}: plan {(tm, tn, n_split)} is not a built tile "
                         f"{mm.FWD_TILES} with 1 <= n_split <= {mm.FWD_MAX_SPLIT}")
    out = torch.empty(*a.shape[:-1], cols, dtype=a.dtype, device=a.device)
    part = (torch.empty(n_split, G, M, cols, dtype=torch.float32, device=a.device)
            if n_split > 1 else None)
    grouped = a.dim() == 3  # the grouped entry takes G
    lib, fn = _entry(lib_name, fn_name, 6, 10 if grouped else 9)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), w.data_ptr(), ids.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), *((G,) if grouped else ()), M, K,
                N, width, bk, bn, tm, tn, n_split, _stream(a))
    _build.check(lib, rc, f"{what} launch")
    if part is not None:
        (bs_dx_merge if dgrad else bs_fwd_merge)(part, out)
    return out


def bs_fwd_merge(part, out):
    """The merge of a split K1/K4 launch: out = part[0] + part[1] + ... in
    that order, in f32, rounded once to out.dtype; part (n_split, G, M, N)
    f32, out (M, N) (G = 1) or (G, M, N).  The masked forward's merge
    (``masked_matmul._merge``: ``masked_merge_kernel``) on CUDA tensors,
    one launch counted in ``fwd_merge_launches``; its plain version on CPU
    tensors."""
    global fwd_merge_launches
    from .masked_matmul import _merge  # masked_matmul imports this module

    _merge("bs_fwd_merge", part, out.view(part.shape[1:]))
    if out.device.type != "cpu":
        fwd_merge_launches += 1
    return out


def bs_dx_merge(part, out):
    """The merge of a split K2/K5 launch: out = part[0] + part[1] + ... in
    that order, in f32, rounded once to out.dtype; part (n_split, G, M, K)
    f32, out (M, K) (G = 1) or (G, M, K).  The masked forward's merge
    (``masked_matmul._merge``: ``masked_merge_kernel``) on CUDA tensors,
    one launch counted in ``dx_merge_launches``; its plain version on CPU
    tensors."""
    global dx_merge_launches
    from .masked_matmul import _merge  # masked_matmul imports this module

    _merge("bs_dx_merge", part, out.view(part.shape[1:]))
    if out.device.type != "cpu":
        dx_merge_launches += 1
    return out


def block_sparse_dx(g, w, ridx, rcnt, *, bm: int, bn: int, bk: int, plan=None, live=None):
    """K2: g (M, N) @ block-sparse w (K, N)^T -> dx (M, K) in g.dtype, over
    the CSR pack ``ridx (K/bk, row_width)`` / ``rcnt (K/bk,)``.  M must be a
    multiple of ``bm``, the caller's row padding; the plan's tile decides
    the launch.  ``dx_plan`` picks it from ``live``, the forward pack's live
    blocks (a host int the caller has: the pack entry's nnz, never a
    superset's bnnz; without one every slot K/bk * row_width counts), or
    ``plan`` = (bm, bn, n_split) forces one (one of
    ``masked_matmul.FWD_TILES``); a split is merged by ``bs_dx_merge``.
    CUDA tensors run the kernel or raise; CPU tensors run the plain
    version."""
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
    dx = _packed_gemm("block_sparse_dx", "block_sparse_bwd", f"block_sparse_dx_{s}", g, w,
                      ridx, rcnt, 1, bk, bn, plan, live, dgrad=True)
    dx_launches += 1
    return dx


def block_sparse_dw(x, g, idx, cnt, *, bn: int, bk: int, plan=None, live=None):
    """K3: dw (K, N) in x.dtype holding x^T @ g on the active blocks of the
    CSC pack ``idx``/``cnt`` and zeros elsewhere.  x (M, K), g (M, N); M a
    multiple of 16 (``kernels/ops.py`` pads rows).  ``dw_plan`` picks the
    launch from ``live``, the pack's live blocks
    (a host int the caller has: the pack entry's nnz or bnnz; without one
    every slot N/bn * width counts), or ``plan`` = (bm, bn, n_split)
    forces one (a built wgrad tile that holds the block); a split is merged
    by ``bs_dw_merge``.  CUDA tensors run the kernel or raise; CPU tensors
    run the plain version."""
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
    dw = _dw_gemm("block_sparse_dw", "block_sparse_bwd", f"block_sparse_dw_{s}", x, g,
                  idx, cnt, 1, bn, bk, plan, live)
    dw_launches += 1
    return dw


def _dw_gemm(what, lib_name, fn_name, x, g, idx, cnt, G, bn, bk, plan, live, fused=None,
             out_dtype=None):
    """One K3 (G = 1: x (M, K), g (M, N), a 2-D pack) or K6 (x (G, M, K), g
    (G, M, N), a stacked pack) launch on the plan's tile and split, and the
    merge after a split: dw (K, N) or (G, K, N), zero-filled, the live
    blocks written.  With ``fused`` = (w, mom, seed, mu, wd, sr) K7 or K8
    (``fn_name`` the entry with its <T>_<mom>_<out> suffix): the new
    momentum in ``out_dtype`` on the live blocks, the plan on the fused
    kernel's own slots, a split merged by ``bs_dw_fused_merge``.  The plan
    counts ``live`` CTAs (every slot when None); no pack count is read on
    the host."""
    from . import masked_matmul as mm  # masked_matmul imports this module

    M, K, N, width = x.shape[-2], x.shape[-1], g.shape[-1], idx.shape[-1]
    live = G * (N // bn) * width if live is None else int(live)
    kinds = () if fused is None else (fused[1].dtype, out_dtype)
    tm, tn, n_split = plan or _dw_plan_for(M, K, N, G, x.dtype, bn, live, x.device.index,
                                           *kinds)
    if ((tm, tn) not in mm.DW_TILES or bk > tm or bn > tn
            or not 1 <= n_split <= -(-M // mm.FWD_SLAB)):
        raise ValueError(f"{what}: plan {(tm, tn, n_split)} is not a built tile "
                         f"{mm.DW_TILES} holding the ({bk}, {bn}) block with 1 <= "
                         f"n_split <= ceil({M} / {mm.FWD_SLAB})")
    out = torch.zeros(*x.shape[:-2], K, N, dtype=out_dtype or x.dtype, device=x.device)
    part = (torch.empty(n_split, G, N // bn, width, bk, bn, dtype=torch.float32,
                        device=x.device) if n_split > 1 else None)
    ptrs, tail = [x, g, idx, cnt], ()
    if fused is not None:
        w, mom, seed, mu, wd, sr = fused
        ptrs += [w, mom]
        tail = (int(seed) & 0xFFFFFFFF, float(mu), float(wd), int(bool(sr)))
    grouped = x.dim() == 3  # the grouped entry takes G
    lib, fn = _entry(lib_name, fn_name, len(ptrs) + 2, 10 if grouped else 9,
                     _FUSED_TAIL if tail else ())
    with torch.cuda.device(x.device):
        rc = fn(*(t.data_ptr() for t in ptrs), out.data_ptr(),
                None if part is None else part.data_ptr(), *((G,) if grouped else ()), M, K,
                N, width, bk, bn, tm, tn, n_split, *tail, _stream(x))
    _build.check(lib, rc, f"{what} launch")
    if part is not None:
        if fused is None:
            bs_dw_merge(part, idx, cnt, out)
        else:
            bs_dw_fused_merge(part, idx, cnt, w, mom, out, seed, mu=mu, wd=wd, sr=sr)
    return out


def _packed_dims(what, part, idx, cnt, out):
    """The merge entries' (G, K, N, width, bk, bn, n_split) of the packed
    f32 partials ``part`` (n_split, G, N/bn, width, bk, bn) of ``out`` (G,
    K, N) or (K, N) on the pack ``idx``/``cnt``; raises where they do not
    match."""
    n_split, G, nnb, width, bk, bn = part.shape
    K, N = out.shape[-2:]
    if (part.dtype != torch.float32 or not part.is_contiguous() or not out.is_contiguous()
            or out.dim() != idx.dim() or (out.shape[0] if out.dim() == 3 else 1) != G
            or N != nnb * bn or tuple(idx.shape[-2:]) != (nnb, width)
            or idx.dtype != torch.int32 or cnt.dtype != torch.int32
            or any(t.device != out.device for t in (part, idx, cnt))):
        raise ValueError(f"{what}: part {tuple(part.shape)} {part.dtype} does not hold "
                         f"the packed partials of {tuple(out.shape)} on the pack "
                         f"{tuple(idx.shape)}")
    return G, K, N, width, bk, bn, n_split


def bs_dw_merge(part, idx, cnt, dw):
    """The merge of a split K3/K6 launch: the packed f32 partials ``part``
    (n_split, G, N/bn, width, bk, bn) summed in order into dw's live blocks
    (``bs_dw_merge_plain``'s function).  CUDA tensors run the merge kernel
    (one launch, counted in ``dw_merge_launches``) or raise; CPU tensors run
    the plain version."""
    global dw_merge_launches
    if dw.device.type == "cpu":
        return bs_dw_merge_plain(part, idx, cnt, dw)
    if dw.device.type != "cuda":
        raise ValueError(f"bs_dw_merge: unsupported device {dw.device}")
    s = _suffix("bs_dw_merge", dw)
    dims = _packed_dims("bs_dw_merge", part, idx, cnt, dw)
    lib, fn = _entry("block_sparse_bwd", f"block_sparse_dw_merge_{s}", 4, 7)
    with torch.cuda.device(dw.device):
        rc = fn(part.data_ptr(), idx.data_ptr(), cnt.data_ptr(), dw.data_ptr(), *dims,
                _stream(dw))
    _build.check(lib, rc, "bs_dw_merge launch")
    dw_merge_launches += 1
    return dw


def bs_dw_fused_merge(part, idx, cnt, w, mom, out, seed: int, *, mu: float, wd: float,
                      sr: bool):
    """The merge of a split K7/K8 launch: the packed f32 partials ``part``
    (n_split, G, N/bn, width, bk, bn) summed in order, then the momentum
    epilogue (sr on the element ids of out's shape, one rounding), into
    out's live blocks (``bs_dw_fused_merge_plain``'s function).  CUDA
    tensors run the merge kernel (one launch, counted in
    ``dw_fused_merge_launches``) or raise; CPU tensors run the plain
    version."""
    global dw_fused_merge_launches
    if out.device.type == "cpu":
        return bs_dw_fused_merge_plain(part, idx, cnt, w, mom, out, seed, mu=mu, wd=wd, sr=sr)
    if out.device.type != "cuda":
        raise ValueError(f"bs_dw_fused_merge: unsupported device {out.device}")
    dims = _packed_dims("bs_dw_fused_merge", part, idx, cnt, out)
    e = _fused_entry_name("bs_dw_fused_merge", _suffix("bs_dw_fused_merge", w),
                          tuple(out.shape), w, w, mom, out.dtype)
    lib, fn = _entry("block_sparse_bwd", f"block_sparse_dw_fused_merge_{e}", 6, 7, _FUSED_TAIL)
    with torch.cuda.device(out.device):
        rc = fn(part.data_ptr(), idx.data_ptr(), cnt.data_ptr(), w.data_ptr(), mom.data_ptr(),
                out.data_ptr(), *dims, int(seed) & 0xFFFFFFFF, float(mu), float(wd),
                int(bool(sr)), _stream(out))
    _build.check(lib, rc, "bs_dw_fused_merge launch")
    dw_fused_merge_launches += 1
    return out


def block_sparse_dw_fused(x, g, idx, cnt, w, mom, seed: int, *, mu: float, wd: float,
                          sr: bool, bn: int, bk: int, out_dtype=None, plan=None, live=None):
    """K7: the new SGD momentum ``mu * mom + x^T @ g + wd * w`` (K, N) on the
    active blocks of the CSC pack ``idx``/``cnt`` (the Top-KAST superset on
    the training path) and zeros elsewhere, in ``out_dtype`` (default
    w.dtype), stochastically rounded onto the bf16 grid when ``sr``, with
    the uint32 ``seed``.  x (M, K), g (M, N) and w (K, N) of one dtype, mom
    (K, N) bf16 or f32; M a multiple of 16.  K3's launch with the momentum
    epilogue: ``dw_plan`` picks it from ``live`` (the pack's live blocks, a
    host int: the entry's bnnz or nnz; without one every slot counts) on
    the fused kernel's own slots, or ``plan`` = (bm, bn, n_split) forces one
    (a built wgrad tile that holds the block); a split is merged by
    ``bs_dw_fused_merge``.  CUDA tensors run the kernel or raise; CPU
    tensors run the plain version."""
    global fused_launches
    out_dtype = out_dtype or w.dtype
    if x.device.type == "cpu":
        return block_sparse_dw_fused_plain(x, g, idx, cnt, w, mom, seed, mu=mu, wd=wd,
                                           sr=sr, bk=bk, bn=bn, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_dw_fused: unsupported device {x.device}")
    (M, K), N = x.shape, g.shape[1]
    s = _check_cuda("block_sparse_dw_fused", x, g, {"idx": idx, "cnt": cnt},
                    {"bn": bn, "bk": bk}, [(M, 16), (K, bk), (N, bn)],
                    [(g.shape[0], M)])
    if idx.dim() != 2 or idx.shape[0] != N // bn or cnt.shape != (N // bn,):
        raise ValueError(f"block_sparse_dw_fused: pack idx {tuple(idx.shape)} / cnt "
                         f"{tuple(cnt.shape)} does not match N/bn = {N // bn}")
    e = _fused_entry_name("block_sparse_dw_fused", s, (K, N), x, w, mom, out_dtype)
    out = _dw_gemm("block_sparse_dw_fused", "block_sparse_bwd", f"block_sparse_dw_fused_{e}",
                   x, g, idx, cnt, 1, bn, bk, plan, live, (w, mom, seed, mu, wd, sr),
                   out_dtype)
    fused_launches += 1
    return out


def _check_grouped(what, a, b, pack, rows, blk):
    """The grouped operands are 3-D with one group count G, and the stacked
    pack ``(G, rows / blk, width)`` / ``(G, rows / blk)`` matches them."""
    G = a.shape[0]
    if a.dim() != 3 or b.dim() != 3 or b.shape[0] != G:
        raise ValueError(f"{what}: operands {tuple(a.shape)}, {tuple(b.shape)} "
                         "must be 3-D with one group dim")
    idx, cnt = pack
    n = rows // blk
    if idx.dim() != 3 or idx.shape[:2] != (G, n) or cnt.shape != (G, n):
        raise ValueError(f"{what}: pack {tuple(idx.shape)} / {tuple(cnt.shape)} does "
                         f"not match (G, {rows}/{blk}) = ({G}, {n})")


def grouped_block_sparse_dx(g, w, ridx, rcnt, *, bm: int, bn: int, bk: int, plan=None,
                            live=None):
    """K5: g (G, M, N) @ block-sparse w (G, K, N)^T -> dx (G, M, K) in
    g.dtype, every group in one launch, over the stacked CSR ``ridx (G,
    K/bk, row_width)`` / ``rcnt (G, K/bk)``; a dead expert's rows are
    zeros.  M must be a multiple of ``bm``; ``plan`` and ``live`` (the live
    blocks of the whole bank) as for ``block_sparse_dx``.  CUDA tensors
    run the kernel or raise; CPU tensors run the plain version."""
    global gdx_launches
    if g.device.type == "cpu":
        return grouped_block_sparse_dx_plain(g, w, ridx, rcnt, bk, bn)
    if g.device.type != "cuda":
        raise ValueError(f"grouped_block_sparse_dx: unsupported device {g.device}")
    _check_grouped("grouped_block_sparse_dx", g, w, (ridx, rcnt), w.shape[1], bk)
    (G, M, N), K = g.shape, w.shape[1]
    s = _check_cuda("grouped_block_sparse_dx", g, w, {"ridx": ridx, "rcnt": rcnt},
                    {"bm": bm, "bn": bn, "bk": bk},
                    [(M, bm), (K, bk), (N, bn)], [(w.shape[2], N)])
    dx = _packed_gemm("grouped_block_sparse_dx", "block_sparse_grouped",
                      f"block_sparse_grouped_dx_{s}", g, w, ridx, rcnt, G, bk, bn, plan, live,
                      dgrad=True)
    gdx_launches += 1
    return dx


def grouped_block_sparse_dw(x, g, idx, cnt, *, bn: int, bk: int, plan=None, live=None):
    """K6: dw (G, K, N) in x.dtype holding x[g]^T @ g[g] on the active
    blocks of the stacked CSC ``idx (G, N/bn, width)`` / ``cnt (G, N/bn)``
    (the Top-KAST superset on the training path) and zeros elsewhere.  x
    (G, M, K), g (G, M, N); M a multiple of 16 (``kernels/ops.py`` pads
    rows); ``plan`` and ``live`` (the live blocks of the whole bank) as for
    ``block_sparse_dw``."""
    global gdw_launches
    if x.device.type == "cpu":
        return grouped_block_sparse_dw_plain(x, g, idx, cnt, bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_block_sparse_dw: unsupported device {x.device}")
    _check_grouped("grouped_block_sparse_dw", x, g, (idx, cnt), g.shape[-1], bn)
    (G, M, K), N = x.shape, g.shape[2]
    s = _check_cuda("grouped_block_sparse_dw", x, g, {"idx": idx, "cnt": cnt},
                    {"bn": bn, "bk": bk}, [(M, 16), (K, bk), (N, bn)],
                    [(g.shape[1], M)])
    dw = _dw_gemm("grouped_block_sparse_dw", "block_sparse_grouped",
                  f"block_sparse_grouped_dw_{s}", x, g, idx, cnt, G, bn, bk, plan, live)
    gdw_launches += 1
    return dw


def grouped_block_sparse_dw_fused(x, g, idx, cnt, w, mom, seed: int, *, mu: float,
                                  wd: float, sr: bool, bn: int, bk: int, out_dtype=None,
                                  plan=None, live=None):
    """K8: K7 for every group of a bank in one launch: the new momentum (G,
    K, N) on the active blocks of the stacked CSC ``idx (G, N/bn, width)`` /
    ``cnt (G, N/bn)``, zeros elsewhere (a group with no block: all zeros);
    sr ids (g * K + row) * N + col.  x (G, M, K), g (G, M, N), w and mom
    (G, K, N); M a multiple of 16; ``plan`` and ``live`` (the live blocks
    of the whole bank) as for ``block_sparse_dw_fused``."""
    global g_fused_launches
    out_dtype = out_dtype or w.dtype
    if x.device.type == "cpu":
        return grouped_block_sparse_dw_fused_plain(x, g, idx, cnt, w, mom, seed, mu=mu,
                                                   wd=wd, sr=sr, bk=bk, bn=bn,
                                                   out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_block_sparse_dw_fused: unsupported device {x.device}")
    _check_grouped("grouped_block_sparse_dw_fused", x, g, (idx, cnt), g.shape[-1], bn)
    (G, M, K), N = x.shape, g.shape[2]
    s = _check_cuda("grouped_block_sparse_dw_fused", x, g, {"idx": idx, "cnt": cnt},
                    {"bn": bn, "bk": bk}, [(M, 16), (K, bk), (N, bn)],
                    [(g.shape[1], M)])
    e = _fused_entry_name("grouped_block_sparse_dw_fused", s, (G, K, N), x, w, mom,
                          out_dtype)
    out = _dw_gemm("grouped_block_sparse_dw_fused", "block_sparse_grouped",
                   f"block_sparse_grouped_dw_fused_{e}", x, g, idx, cnt, G, bn, bk, plan, live,
                   (w, mom, seed, mu, wd, sr), out_dtype)
    g_fused_launches += 1
    return out


class BlockSparseMatmul(torch.autograd.Function):
    """y = x @ W on the CSC pack; backward dx on the CSR pack (K2) and dw
    on the same CSC pack (K3), as the reference's ``_bs_fwd/_bs_bwd``.
    ``ridx``/``rcnt`` None derives the CSR at the worst-case width.
    ``live``: the pack's active blocks as a host int (K1's, K2's and K3's
    plans), or None."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, idx, cnt, ridx, rcnt, bm, bn, bk, live=None):
        ctx.save_for_backward(x, w, idx, cnt, ridx, rcnt)
        ctx.blocks, ctx.live, ctx.nnz = (bm, bn, bk), live, live
        return block_sparse_matmul(x, upcast(w, x), idx, cnt, bm=bm, bn=bn, bk=bk, live=live)

    @staticmethod
    def backward(ctx, g):
        x, w, idx, cnt, ridx, rcnt = ctx.saved_tensors
        return _backward(ctx, g, x, w, idx, cnt, ridx, rcnt, idx, cnt) + (None,) * 8


class TopkastBlockSparseMatmul(torch.autograd.Function):
    """Forward and dx on the forward pack (A), dw on the Top-KAST superset
    CSC ``bidx``/``bcnt`` (B ⊇ A), as the reference's ``_tk_fwd/_tk_bwd``:
    dw is the dense gradient restricted to B's blocks.  Given ``mom``, the
    weight cotangent IS the new SGD momentum ``mu * mom + x^T @ g + wd * w``
    on B's blocks (K7 in K3's place), as the reference's ``_fbs_fwd/_fbs_bwd``
    (B is the forward CSC when the entry has no superset); ``mom`` and
    ``seed`` get no gradient.  ``live``: B's active blocks as a host int
    (K3's plan), or None; ``nnz``: A's (K1's and K2's plans), or None."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, idx, cnt, ridx, rcnt, bidx, bcnt, bm, bn, bk, mom=None, seed=0,
                mu=0.0, wd=0.0, sr=False, live=None, nnz=None):
        ctx.save_for_backward(x, w, idx, cnt, ridx, rcnt, bidx, bcnt, mom)
        ctx.blocks, ctx.live, ctx.nnz = (bm, bn, bk), live, nnz
        ctx.epilogue = dict(seed=int(seed), mu=float(mu), wd=float(wd), sr=bool(sr))
        return block_sparse_matmul(x, upcast(w, x), idx, cnt, bm=bm, bn=bn, bk=bk, live=nnz)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, *ctx.saved_tensors) + (None,) * 16


class GroupedBlockSparseMatmul(torch.autograd.Function):
    """y[g] = x[g] @ W[g] over a bank's stacked CSC pack (K4); backward dx
    on the stacked CSR (K5) and dw on the same CSC (K6), as the reference's
    ``_gbs_fwd/_gbs_bwd``.  ``ridx``/``rcnt`` None derives the stacked CSR
    at the worst-case width; ``live`` as for ``BlockSparseMatmul`` (the
    whole bank's)."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, idx, cnt, ridx, rcnt, bm, bn, bk, live=None):
        ctx.save_for_backward(x, w, idx, cnt, ridx, rcnt)
        ctx.blocks, ctx.live, ctx.nnz = (bm, bn, bk), live, live
        return grouped_block_sparse_matmul(x, upcast(w, x), idx, cnt, bm=bm, bn=bn, bk=bk,
                                           live=live)

    @staticmethod
    def backward(ctx, g):
        x, w, idx, cnt, ridx, rcnt = ctx.saved_tensors
        return _backward(ctx, g, x, w, idx, cnt, ridx, rcnt, idx, cnt,
                         grouped=True) + (None,) * 8


class TopkastGroupedBlockSparseMatmul(torch.autograd.Function):
    """The grouped Top-KAST split, as the reference's ``_gtk_fwd/_gtk_bwd``:
    forward (K4) and dx (K5) on each group's forward pack A, dw (K6) on the
    stacked superset CSC ``bidx``/``bcnt`` (B ⊇ A).  Given ``mom``, the
    weight cotangent is the new momentum on B's blocks (K8 in K6's place),
    as the reference's ``_gfbs_fwd/_gfbs_bwd``: a group with no block gets
    zeros.  ``live`` and ``nnz`` as for ``TopkastBlockSparseMatmul``."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, idx, cnt, ridx, rcnt, bidx, bcnt, bm, bn, bk, mom=None, seed=0,
                mu=0.0, wd=0.0, sr=False, live=None, nnz=None):
        ctx.save_for_backward(x, w, idx, cnt, ridx, rcnt, bidx, bcnt, mom)
        ctx.blocks, ctx.live, ctx.nnz = (bm, bn, bk), live, nnz
        ctx.epilogue = dict(seed=int(seed), mu=float(mu), wd=float(wd), sr=bool(sr))
        return grouped_block_sparse_matmul(x, upcast(w, x), idx, cnt, bm=bm, bn=bn, bk=bk,
                                           live=nnz)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, *ctx.saved_tensors, grouped=True) + (None,) * 16


def _backward(ctx, g, x, w, idx, cnt, ridx, rcnt, didx, dcnt, mom=None, grouped=False):
    """dx on the CSR (derived from the forward CSC when None; its plan on
    the forward pack's live blocks ``ctx.nnz``) and dw on the CSC
    ``didx``/``dcnt`` (its plan on ``ctx.live``): K2/K3, or K5/K6 for a
    bank; with ``mom`` the weight cotangent is the fused epilogue's new
    momentum (K7, or K8, its plan on ``ctx.live`` too).  A narrower w (a
    bf16 master under f32 compute) is upcast for its launch only and its
    cotangent rounded once to w.dtype (``upcast``)."""
    bm, bn, bk = ctx.blocks
    dx_fn, dw_fn, fused_fn = (
        (grouped_block_sparse_dx, grouped_block_sparse_dw, grouped_block_sparse_dw_fused)
        if grouped else (block_sparse_dx, block_sparse_dw, block_sparse_dw_fused))
    g = g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        if ridx is None:
            ridx, rcnt = csr_of(idx, cnt, w.shape[-2] // bk)
        dx = dx_fn(g, upcast(w, x), ridx, rcnt, bm=bm, bn=bn, bk=bk, live=ctx.nnz)
    if ctx.needs_input_grad[1]:
        if mom is None:
            dw = dw_fn(x, g, didx, dcnt, bn=bn, bk=bk, live=ctx.live)
        else:
            dw = fused_fn(x, g, didx, dcnt, upcast(w, x), mom, bn=bn, bk=bk, live=ctx.live,
                          **ctx.epilogue)
        dw = dw.to(w.dtype)
    return dx, dw


def upcast(w, x):
    """``w`` in x's dtype for one launch: a bf16 master under f32 compute
    (grok-1-314b's banks) is cast here, inside the kernel's Function, so
    the f32 copy lives for that launch only and is never saved for the
    backward (which casts again); the same tensor otherwise."""
    return w if w.dtype == x.dtype else w.to(x.dtype)
