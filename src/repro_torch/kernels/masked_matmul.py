"""Masked matmul y = x @ (w * m) with an elementwise mask, forward and
backward, and the fused SGD wgrad epilogue.

Replaces eight TPU kernels of ``repro/kernels/masked_matmul.py`` with
hand-written CUDA kernels for Hopper (sm_90a), all in
csrc/masked_matmul.cu (the design and its bound are described there):

  K13 ``_fwd_kernel`` (``_fwd_call``)     y = x @ (w * m)
  K16 ``_g_fwd_kernel`` (``_g_fwd_call``) y[g] = x[g] @ (w[g] * m[g]) for
        every group of a (G, K, N) weight bank (the MoE experts), one launch
  K14 ``_dx_kernel`` (``_dx_call``)       dx = g @ (w * m)^T
  K17 ``_g_dx_kernel`` (``_g_dx_call``)   dx[g] = g[g] @ (w[g] * m[g])^T
  K15 ``_dw_kernel`` (``_dw_call``)       dw = (x^T @ g) * m
  K18 ``_g_dw_kernel`` (``_g_dw_call``)   dw[g] = (x[g]^T @ g[g]) * m[g]
  K19 ``_dw_fused_kernel`` (``_dw_fused_call``)
        m_new = (mu * mom + x^T @ g + wd * w) * m, stochastically rounded
        onto the bf16 grid (``sr_to_bf16``) when ``sr``
  K20 ``_g_dw_fused_kernel`` (``_g_dw_fused_call``)  K19 per group of a
        bank; the sr ids gain g * K * N

Each runs in bf16 and in f32 (the reference's MLP computes in the f32
residual's dtype), accumulating in f32 and rounding once to the output
type.  All eight run on the register-resident GEMM core
(csrc/gemm_core.cuh: mma.sync bf16, and 3xTF32 for f32, which keeps f32's
digits on the tensor cores); K19 and K20 are the wgrad's walk with the
momentum epilogue at the store.  One plan serves the directions of the
core: ``fwd_plan`` sees a launch as rows x contraction -> rows x cols (the
forward: L = K, cols = N; the dgrad: L = N, cols = K; the wgrads: rows =
K, L = M, cols = N), picks the tile and splits the contraction where the
grid alone would leave the SMs' slots empty (decode) or its last wave
mostly idle (the wgrads', ``entry="dw"`` and ``"dw_fused"``, keep 128
rows; K15/K18's halves the tile of a one-slab walk in bf16); a split's f32
partials are summed in order by a merge kernel (``fwd_merge`` after K13 and K16,
``dx_merge`` after K14 and K17, ``dw_merge`` after K15 and K18, which then
multiplies by the mask, ``dw_fused_merge`` after K19 and K20, which then
applies the momentum epilogue; the block-sparse kernels K1-K6 of
``block_sparse_matmul`` run on the same core, count their own grids and
take the same split rule, ``fwd_split``).  The mask multiplies the weight,
or in the wgrads the f32 sum (an inf or NaN under a zero mask gives NaN,
as the reference's ``w * m.astype(w.dtype)``, ``acc * m.astype(f32)`` and
``(...) * mk``); it is never a select.

Every wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version (``*_plain``) only for CPU tensors.  ``launches``,
``g_launches``, ``dx_launches``, ``gdx_launches``, ``dw_launches``,
``gdw_launches``, ``fused_launches`` and ``g_fused_launches`` count kernel
launches, one per call; ``fwd_merge_launches`` counts the split merges of
K13 and K16 on their own, ``dx_merge_launches`` those of K14 and K17,
``dw_merge_launches`` those of K15 and K18, ``dw_fused_merge_launches``
those of K19 and K20.
``MaskedMatmul``, ``TopkastMaskedMatmul``, ``FusedMaskedMatmul``,
``GroupedMaskedMatmul``, ``TopkastGroupedMaskedMatmul`` and
``FusedGroupedMaskedMatmul`` are the differentiable forms (the
reference's custom VJPs ``_mm_fwd/_mm_bwd``, ``_tkm_fwd/_tkm_bwd``,
``_fmm_fwd/_fmm_bwd``, ``_gmm_fwd/_gmm_bwd``, ``_gtkm_fwd/_gtkm_bwd`` and
``_gfmm_fwd/_gfmm_bwd``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .opaque import opaque
from .block_sparse_matmul import (
    _FUSED_TAIL,
    _fused_entry_name,
    _stream,
    _suffix,
    matmul_error_bound,
    upcast,
)

__all__ = [
    "DW_TILES",
    "FWD_SLAB",
    "FWD_TILES",
    "FusedGroupedMaskedMatmul",
    "FusedMaskedMatmul",
    "GroupedMaskedMatmul",
    "MaskedMatmul",
    "TopkastGroupedMaskedMatmul",
    "TopkastMaskedMatmul",
    "WGRADS",
    "dw_fused_merge",
    "dw_fused_merge_launches",
    "dw_launches",
    "dw_merge",
    "dw_merge_launches",
    "dx_launches",
    "dx_merge",
    "dx_merge_launches",
    "fused_error_bound",
    "fused_launches",
    "fwd_candidates",
    "fwd_launch_info",
    "fwd_merge",
    "fwd_merge_launches",
    "fwd_merge_plain",
    "fwd_plan",
    "fwd_split",
    "fwd_split_candidates",
    "fwd_split_ranges",
    "fwd_tile",
    "g_fused_launches",
    "g_launches",
    "gdw_launches",
    "gdx_launches",
    "grouped_masked_dw",
    "grouped_masked_dw_fused",
    "grouped_masked_dw_fused_plain",
    "grouped_masked_dw_plain",
    "grouped_masked_dx",
    "grouped_masked_dx_plain",
    "grouped_masked_matmul",
    "grouped_masked_matmul_plain",
    "launch_info",
    "launches",
    "masked_dw",
    "masked_dw_fused",
    "masked_dw_fused_merge_plain",
    "masked_dw_fused_plain",
    "masked_dw_fused_split_plain",
    "masked_dw_plain",
    "masked_dw_split_plain",
    "masked_dx",
    "masked_dx_plain",
    "masked_dx_split_plain",
    "masked_matmul",
    "masked_matmul_plain",
    "masked_matmul_split_plain",
    "matmul_error_bound",
    "sr_to_bf16",
]

# kernel launches since import (or since a caller reset them)
launches = 0        # K13
g_launches = 0      # K16
dx_launches = 0     # K14
dw_launches = 0     # K15
gdx_launches = 0    # K17
gdw_launches = 0    # K18
fused_launches = 0  # K19
g_fused_launches = 0  # K20
fwd_merge_launches = 0  # the merges of split K13 and K16 launches
dx_merge_launches = 0  # the merges of split K14 and K17 launches
dw_merge_launches = 0  # the merges of split K15 and K18 launches
dw_fused_merge_launches = 0  # the merges of split K19 and K20 launches

# the GEMM core's plan, K13/K16, K14/K17, K15/K18 and K19/K20
# (csrc/masked_matmul.cu, csrc/gemm_core.cuh)
FWD_SLAB = 32  # contraction elements of one ring stage; a split walks whole slabs
FWD_TILES = ((128, 128), (128, 64), (16, 64))  # (bm, bn) built
DW_TILES = FWD_TILES[:2]  # K15/K18's and K19/K20's (their rows are K, never a decode's)
WGRADS = ("dw", "dw_fused")  # the plan entries of the wgrads: K15/K18, K19/K20
FWD_SPLITS = (1, 2, 4, 8, 16, 32)  # the sweeps' split counts (all weighed by K1/K3/K4/K6)
FWD_MAX_SPLIT = 32
FWD_MIN_SLABS = 2  # slabs a split walks at least
# fwd_plan's model of the dense shapes: the kernel's own rate (flop/s, at
# danube's M = 2048 shapes on an H100 80GB HBM3 at 700 W, chip_smoke.py;
# PERF.md), the card's memory rate, the least modelled gain of a split
FWD_RATE = {torch.bfloat16: 2.6e14, torch.float32: 4.2e13}
FWD_BYTES_S = 3.35e12
FWD_MIN_GAIN = 0.05
_ELEMENT = {torch.bfloat16: 2, torch.float32: 4}
_SFX = {torch.bfloat16: "bf16", torch.float32: "f32"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32): split so that no
    product leaves int64's range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sr_to_bf16(v: torch.Tensor, seed: int, gid: torch.Tensor) -> torch.Tensor:
    """Stochastically round f32 values onto the bf16 grid (f32 result whose
    values are bf16-representable); bit for bit the reference's
    ``repro/kernels/masked_matmul.py::sr_to_bf16``.

    A murmur-style finaliser of ``gid ^ seed`` supplies 16 uniform bits
    added below the bf16 mantissa cut; truncation then lands on the lower or
    upper bf16 neighbour with probability equal to the distance (a mantissa
    carry moves into the exponent: the round-up to the next binade).
    Non-finite values pass through.  ``seed``: an int, taken as uint32;
    ``gid``: integer element ids (taken mod 2**32).  The uint32 arithmetic
    runs in int64, masked to 32 bits after every step.
    """
    h = (gid.to(torch.int64) ^ (int(seed) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    v32 = v.to(torch.float32)
    bits = v32.view(torch.int32).to(torch.int64) & _M32
    r = (bits + (h & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(v32), r, v32)


def _gid(K: int, N: int, device, G=None) -> torch.Tensor:
    """Element ids row * N + col of a (K, N) array, or (g * K + row) * N +
    col of a (G, K, N) bank (the reference's gid), exact in int64:
    ``sr_to_bf16`` takes them mod 2**32, which is the reference's wrapping
    uint32 arithmetic."""
    shape = (K, N) if G is None else (G, K, N)
    return torch.arange(math.prod(shape), device=device,
                        dtype=torch.int64).reshape(shape)


def masked_matmul_plain(x, w, mask):
    """Plain K13: ``x @ (w * m)`` with f32 accumulation, rounded once to
    x.dtype (the mask multiplies in w's dtype, as the reference)."""
    wm = w * mask.to(w.dtype)
    return (x.float() @ wm.float()).to(x.dtype)


def grouped_masked_matmul_plain(x, w, mask):
    """Plain K16: per group ``x[g] @ (w[g] * m[g])`` with f32 accumulation,
    rounded once to x.dtype."""
    wm = w * mask.to(w.dtype)
    return torch.bmm(x.float(), wm.float()).to(x.dtype)


def masked_dx_plain(g, w, mask):
    """Plain K14: ``g @ (w * m)^T`` in f32, rounded once to g.dtype."""
    wm = w * mask.to(w.dtype)
    return (g.float() @ wm.float().T).to(g.dtype)


def masked_dw_plain(x, g, mask):
    """Plain K15: ``(x^T @ g) * m`` in f32, rounded once to x.dtype."""
    return ((x.float().T @ g.float()) * mask.float()).to(x.dtype)


def grouped_masked_dx_plain(g, w, mask):
    """Plain K17: per group ``g[g] @ (w[g] * m[g])^T`` in f32, rounded once
    to g.dtype."""
    wm = w * mask.to(w.dtype)
    return torch.bmm(g.float(), wm.float().transpose(1, 2)).to(g.dtype)


def grouped_masked_dw_plain(x, g, mask):
    """Plain K18: per group ``(x[g]^T @ g[g]) * m[g]`` in f32, rounded once
    to x.dtype."""
    return (torch.bmm(x.float().transpose(1, 2), g.float()) * mask.float()).to(x.dtype)


def _momentum(acc, wgm, w, mom, seed: int, mu: float, wd: float, sr: bool, out_dtype):
    """K19/K20's epilogue on the f32 sum ``acc`` of x^T @ g, (K, N) or (G, K,
    N): ``m_new = (mu * mom + acc + wd * w) * wgm`` in f32, left to right as
    the reference; ``sr`` rounds it with ``sr_to_bf16`` on the element ids
    (g * K + row) * N + col (g = 0 for a 2-D weight); rounded once to
    ``out_dtype`` (default w.dtype)."""
    m_new = (mu * mom.float() + acc + wd * w.float()) * wgm.float()
    if sr:
        K, N = m_new.shape[-2:]
        m_new = sr_to_bf16(m_new, seed, _gid(K, N, m_new.device,
                                             G=m_new.shape[0] if m_new.dim() == 3 else None))
    return m_new.to(out_dtype or w.dtype)


def masked_dw_fused_plain(x, g, wgm, w, mom, seed: int, *, mu: float, wd: float,
                          sr: bool, out_dtype=None):
    """Plain K19 (and K20 on a (G, K, N) bank, per group): ``m_new = (mu *
    mom + x^T @ g + wd * w) * wgm`` (``_momentum`` on the f32 sum)."""
    return _momentum(x.float().transpose(-1, -2) @ g.float(), wgm, w, mom, seed, mu, wd, sr,
                     out_dtype)


grouped_masked_dw_fused_plain = masked_dw_fused_plain  # plain K20


def masked_matmul_split_plain(x, w, mask, n_split: int):
    """K13 (x (M, K)) or K16 (x (G, M, K), w and mask (G, K, N)) as a split
    launch computes it: split s's f32 partial over K's slabs [s n //
    n_split, (s + 1) n // n_split) of n = ceil(K / FWD_SLAB), the partials
    summed in the order s = 0, 1, ... and rounded once to x.dtype (the mask
    multiplies in w's dtype, as the reference)."""
    xf, wm = x.float(), (w * mask.to(w.dtype)).float()
    acc = None
    for k0, k1 in fwd_split_ranges(x.shape[-1], n_split):
        part = xf[..., k0:k1] @ wm[..., k0:k1, :]
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def masked_dx_split_plain(g, w, mask, n_split: int):
    """K14 (g (M, N), w and mask (K, N)) or K17 (g (G, M, N), w and mask (G,
    K, N)) as a split launch computes it: split s's f32 partial ``g @ (w *
    m)^T`` over N's slabs ``fwd_split_ranges(N, n_split)[s]``, the partials
    summed in the order s = 0, 1, ... and rounded once to g.dtype (the mask
    multiplies in w's dtype, as the reference)."""
    gf, wm = g.float(), (w * mask.to(w.dtype)).float()
    acc = None
    for n0, n1 in fwd_split_ranges(g.shape[-1], n_split):
        part = gf[..., n0:n1] @ wm[..., n0:n1].transpose(-1, -2)
        acc = part if acc is None else acc + part
    return acc.to(g.dtype)


def _split_xtg(x, g, n_split: int):
    """x^T @ g as a split wgrad launch sums it: split s's f32 partial over
    M's slabs ``fwd_split_ranges(M, n_split)[s]``, the partials summed in
    the order s = 0, 1, ... (2-D, or with a leading group dim)."""
    xf, gf = x.float(), g.float()
    acc = None
    for m0, m1 in fwd_split_ranges(x.shape[-2], n_split):
        part = xf[..., m0:m1, :].transpose(-1, -2) @ gf[..., m0:m1, :]
        acc = part if acc is None else acc + part
    return acc


def masked_dw_split_plain(x, g, mask, n_split: int):
    """K15 (x (M, K), g (M, N), mask (K, N)) or K18 (every operand with a
    leading group dim) as a split launch computes it: the ordered sum of the
    split's partials (``_split_xtg``), then multiplied by the mask and
    rounded once to x.dtype."""
    return (_split_xtg(x, g, n_split) * mask.float()).to(x.dtype)


def masked_dw_fused_split_plain(x, g, wgm, w, mom, seed: int, n_split: int, *, mu: float,
                                wd: float, sr: bool, out_dtype=None):
    """K19 or K20 (every operand with a leading group dim) as a split launch
    computes it: the ordered sum of the split's f32 partials over whole M
    slabs (``_split_xtg``), then the momentum epilogue (``_momentum``: the
    mask, sr), rounded once; at n_split = 1 bit for bit
    ``masked_dw_fused_plain``."""
    return _momentum(_split_xtg(x, g, n_split), wgm, w, mom, seed, mu, wd, sr, out_dtype)


def fwd_split_ranges(L: int, n_split: int) -> list[tuple[int, int]]:
    """The contraction range [l0, l1) each split of a GEMM-core launch walks
    (L = K for K13/K16, N for K14/K17, M for K15/K18): split s takes slabs
    [s n // n_split, (s + 1) n // n_split) of the n = ceil(L / FWD_SLAB)
    slabs (the last slab ends at L)."""
    n = -(-L // FWD_SLAB)
    return [(s * n // n_split * FWD_SLAB, min((s + 1) * n // n_split * FWD_SLAB, L))
            for s in range(n_split)]


def _ordered_sum(part):
    """part[0] + part[1] + ... in that order, in f32."""
    acc = part[0].clone()
    for s in range(1, part.shape[0]):
        acc += part[s]
    return acc


def fwd_merge_plain(part, dtype, mask=None):
    """The split merge: the ordered sum of the partials (f32), times
    ``mask`` where one is given (the wgrad's), rounded once to ``dtype``."""
    acc = _ordered_sum(part)
    if mask is not None:
        acc *= mask.float()
    return acc.to(dtype)


def masked_dw_fused_merge_plain(part, wgm, w, mom, seed: int, *, mu: float, wd: float,
                                sr: bool, out_dtype=None):
    """The merge of a split K19/K20 launch: the ordered sum of the partials
    (f32), then the momentum epilogue (``_momentum``), rounded once."""
    return _momentum(_ordered_sum(part), wgm, w, mom, seed, mu, wd, sr, out_dtype)


def fwd_tile(Mp: int, bn_limit: int = 128, entry: str = "fwd") -> tuple[int, int]:
    """The GEMM core's CTA tile (bm, bn) at Mp padded rows: 16 x 64 for at
    most 64 rows (decode: one row tile, the weight read once; 64 columns
    give twice the CTAs of 128, so fewer splits), else 128 x 128, or 128 x
    64 where the caller's column tile ``bn_limit`` is below 128.  The
    wgrads (``entry`` "dw" or "dw_fused", rows = K) always take 128 rows."""
    bm = 16 if Mp <= 64 and entry not in WGRADS else 128
    return bm, 64 if bm == 16 or bn_limit < 128 else 128


def fwd_split(bm: int, bn: int, tiles: int, cells: int, n_slabs: int, cap: int, dtype,
              slots: int, every: bool = False) -> int:
    """The split of a GEMM-core launch of ``tiles`` CTAs of bm x bn in
    ``dtype``, each walking ``n_slabs`` slabs, on ``slots`` resident CTAs;
    a split's f32 partials are ``cells`` elements, written and read by the
    merge (8 bytes each a split).  Each caller counts its own grid
    (``fwd_plan`` for K13-K18; ``block_sparse_matmul``'s ``fwd_plan`` for
    K1/K4, ``dx_plan`` for K2/K5 and ``dw_plan`` for K3/K6).

    * Decode (bm = 16) reads every weight byte once: the split fills the
      slots in one wave, as far as three limits allow: each split walks at
      least FWD_MIN_SLABS slabs, at most FWD_MAX_SPLIT splits, and at most
      ``cap`` (the caller's bound on the partials' bytes).
    * Larger row counts do the dense work (bm = 128): a split is taken only
      where the modelled makespan -- waves of ``slots`` CTAs, each walking
      its slabs at the kernel's own rate ``FWD_RATE``, plus the partials'
      bytes at FWD_BYTES_S -- drops by FWD_MIN_GAIN or more; the split
      weighed is 2 (the masked grids: hundreds of tiles or more) or, with
      ``every`` (the block-sparse grids: a few dozen live blocks, or short
      walks), every split of FWD_SPLITS that walks at least FWD_MIN_SLABS
      slabs, the one of least makespan."""
    if bm == 16:
        return max(1, min(slots // max(tiles, 1), n_slabs // FWD_MIN_SLABS, cap,
                          FWD_MAX_SPLIT))
    slab_s = 2.0 * bm * bn * FWD_SLAB * slots / FWD_RATE[dtype]  # one CTA's slab

    def makespan(n):
        waves = -(-tiles * n // slots)
        merge = 8.0 * n * cells / FWD_BYTES_S if n > 1 else 0.0
        return waves * -(-n_slabs // n) * slab_s + merge

    splits = [n for n in FWD_SPLITS[1:] if n <= n_slabs // FWD_MIN_SLABS and (n == 2 or every)]
    best = min(splits, key=makespan, default=1)
    return best if splits and makespan(best) <= (1 - FWD_MIN_GAIN) * makespan(1) else 1


def fwd_split_candidates(bm: int, n_slabs: int, cap: int, every: bool = False) -> list[int]:
    """The split counts a sweep forces beside ``fwd_split``'s pick: 1, and
    each of FWD_SPLITS that walks at least FWD_MIN_SLABS slabs -- at decode
    (bm = 16) within twice ``cap``, else all of them with ``every``, else
    2."""
    cap = 2 * cap if bm == 16 else FWD_MAX_SPLIT if every else 2
    return [n for n in FWD_SPLITS if n == 1 or (n <= n_slabs // FWD_MIN_SLABS and n <= cap)]


def fwd_plan(Mp: int, L: int, cols: int, G: int, dtype, slots: int, *,
             bn_limit: int = 128, entry: str = "fwd") -> tuple[int, int, int]:
    """A GEMM-core launch of Mp rows x L contraction -> Mp x cols on a bank
    of G groups of ``dtype`` -> (bm, bn, n_split): ``entry`` "fwd" (K13 with
    G = 1, K16) with L = K and cols = N, "dx" (K14, K17) with L = N and cols
    = K, "dw" (K15, K18) or "dw_fused" (K19, K20: the same walk; their
    merge applies the epilogue after the ordered sum) with Mp = K, L = M and
    cols = N.  ``slots``: the CTAs the card holds at once for the tile
    ``fwd_tile`` picks (SMs times CTAs resident per SM of the entry's own
    kernel).

    The grid has ceil(Mp / bm) ceil(cols / bn) G tiles, and the n = ceil(L
    / FWD_SLAB) slabs may be split into n_split whole-slab parts whose f32
    partials a merge sums (8 G Mp cols bytes a split, written and read);
    ``fwd_split`` picks it.

    * Decode (bm = 16): the partials stay within a quarter of the weight
      and mask bytes (G L cols (e + 1)), so n_split <= L (e + 1) / (32 Mp).
    * A K15/K18 walk of one slab (M <= FWD_SLAB: qwen2-moe's 16-row expert
      banks) in bf16 takes the 128 x 64 tile.  Such a CTA is only its
      copies, one slab and the store; the half tile shortens that chain
      and keeps bf16's two CTAs an SM: 0.337 against 0.356 ms and 0.357
      against 0.368 at the two banks on an H100, while f32's 128 x 64 (one
      CTA an SM, as its 128 x 128) took 0.653 against 0.514 (chip_smoke.py;
      PERF.md).  K19/K20's store moves 4 more bytes a weight (mom and w,
      staged by 16-byte copies), which the 128 x 128 tile streams better:
      0.510 against 0.586 and 0.497 against 0.573 ms at the same banks, so
      the fused wgrad keeps it.
    * Larger row counts weigh a split of 2: it pays where the unsplit grid
      leaves most of its last wave idle (danube's f32 MLP at 2048 rows: the
      forward of wo and the dgrad of wi and wg, 320 CTAs on 132 slots).  The
      banks (660-1320 CTAs) stay whole.

    chip_smoke.py times every candidate (``fwd_candidates``) at the paths'
    shapes and says whether this pick was the fastest."""
    bm, bn = fwd_tile(Mp, bn_limit, entry)
    n_slabs = -(-L // FWD_SLAB)
    if entry == "dw" and n_slabs == 1 and dtype == torch.bfloat16:
        return bm, 64, 1
    cap = L * (_ELEMENT[dtype] + 1) // (32 * Mp)
    return bm, bn, fwd_split(bm, bn, -(-Mp // bm) * -(-cols // bn) * G, G * Mp * cols,
                             n_slabs, cap, dtype, slots)


def fwd_candidates(Mp: int, L: int, cols: int, G: int, dtype, slots: int, *,
                   bn_limit: int = 128, entry: str = "fwd") -> list[tuple[int, int, int]]:
    """The plans a sweep forces at one shape (``fwd_plan``'s arguments):
    every built tile of the row tile ``fwd_tile`` picks whose columns the
    caller allows, each with every split of ``fwd_split_candidates``, and
    ``fwd_plan``'s own pick."""
    bm, _ = fwd_tile(Mp, bn_limit, entry)
    splits = fwd_split_candidates(bm, -(-L // FWD_SLAB), L * (_ELEMENT[dtype] + 1) // (32 * Mp))
    out = [(bm, bn, n) for tbm, bn in FWD_TILES if tbm == bm and bn <= max(bn_limit, 64)
           for n in splits]
    pick = fwd_plan(Mp, L, cols, G, dtype, slots, bn_limit=bn_limit, entry=entry)
    return out if pick in out else out + [pick]


def launch_info(name: str, lib_name: str, *args: int) -> dict:
    """The launch a GEMM-core kernel gets, from its C entry ``name(*args,
    int out[5])`` in ``lib_name``: CTAs resident per SM, registers a thread,
    dynamic shared bytes, local (spill) bytes a thread and threads a CTA,
    from the CUDA runtime.  Needs a card."""
    out = (ctypes.c_int * 5)()
    lib, fn = _fn(name, [_I] * len(args) + [_P], lib_name)
    _build.check(lib, fn(*args, ctypes.addressof(out)), f"{name} launch info")
    return dict(zip(("ctas_per_sm", "registers", "smem_bytes", "spill_bytes", "threads"),
                    list(out)))


def fwd_launch_info(dtype, bm: int, bn: int, entry: str = "fwd",
                    mom_dtype=torch.bfloat16, out_dtype=None) -> dict:
    """``launch_info`` of the GEMM core's kernel at tile (bm, bn) in
    ``dtype``, ``entry`` "fwd" (K13/K16), "dx" (K14/K17), "dw" (K15/K18)
    or "dw_fused" (K19/K20 with mom in ``mom_dtype`` and the output in
    ``out_dtype``, default ``dtype``: by default the fused path's own
    launch).  Needs a card."""
    s = _SFX[dtype]
    if entry == "dw_fused":
        s = f"{s}_{_SFX[mom_dtype]}_{_SFX[out_dtype or dtype]}"
    return launch_info(f"masked_{entry}_info_{s}", "masked_matmul", bm, bn)


@functools.lru_cache(maxsize=4096)
def _fwd_plan_for(Mp, L, cols, G, dtype, bn_limit, device_index, entry="fwd",
                  mom_dtype=torch.bfloat16, out_dtype=None):
    """``fwd_plan`` with the card's slots (SMs times the resident CTAs of
    ``entry``'s kernel at the tile, from the runtime; for "dw_fused" the
    instantiation of ``mom_dtype`` and ``out_dtype``), memoized."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    bm, bn = fwd_tile(Mp, bn_limit, entry)
    slots = sms * fwd_launch_info(dtype, bm, bn, entry, mom_dtype, out_dtype)["ctas_per_sm"]
    return fwd_plan(Mp, L, cols, G, dtype, slots, bn_limit=bn_limit, entry=entry)


def _merge(what, part, out, mask=None, fused=None):
    """``out`` = part[0] + part[1] + ... in order, in f32, times ``mask``
    where one is given (bool, out's shape: the wgrad's merge), or with
    ``fused`` = (w, mom, seed, mu, wd, sr) (w and mom of out's shape) the
    momentum epilogue on the wgrad mask ``mask`` (K19/K20's merge), rounded
    once to out.dtype; part (n_split, *out.shape) f32.  CUDA tensors run the
    merge kernel (one launch) or raise; CPU tensors the plain version."""
    if out.device.type == "cpu":
        if fused is None:
            return out.copy_(fwd_merge_plain(part, out.dtype, mask))
        w, mom, seed, mu, wd, sr = fused
        return out.copy_(masked_dw_fused_merge_plain(part, mask, w, mom, seed, mu=mu, wd=wd,
                                                     sr=sr, out_dtype=out.dtype))
    _device(what, out)
    s = _suffix(what, out)
    if (part.dtype != torch.float32 or part.device != out.device
            or tuple(part.shape[1:]) != tuple(out.shape) or out.numel() % 4
            or not (part.is_contiguous() and out.is_contiguous())):
        raise ValueError(f"{what}: part {tuple(part.shape)} {part.dtype} does not "
                         f"hold f32 partials of out {tuple(out.shape)}")
    tail = ()
    if mask is None:
        lib, fn = _fn(f"masked_merge_{s}", [_P, _P, ctypes.c_longlong, _I, _P])
        args = (part.data_ptr(), out.data_ptr())
    else:
        if (mask.dtype != torch.bool or mask.device != out.device
                or mask.shape != out.shape or not mask.is_contiguous()
                or mask.data_ptr() % 4):
            raise ValueError(f"{what}: mask {tuple(mask.shape)} {mask.dtype} is not a "
                             f"contiguous, aligned bool mask of out {tuple(out.shape)}")
        if fused is None:
            lib, fn = _fn(f"masked_dw_merge_{s}", [_P, _P, _P, ctypes.c_longlong, _I, _P])
            args = (part.data_ptr(), mask.data_ptr(), out.data_ptr())
        else:
            w, mom, seed, mu, wd, sr = fused
            e = _fused_entry_name(what, _suffix(what, w), tuple(out.shape), w, w, mom,
                                  out.dtype)
            lib, fn = _fn(f"masked_dw_fused_merge_{e}",
                          [_P] * 5 + [ctypes.c_longlong, _I] + list(_FUSED_TAIL) + [_P])
            args = (part.data_ptr(), mask.data_ptr(), w.data_ptr(), mom.data_ptr(),
                    out.data_ptr())
            tail = (int(seed) & _M32, float(mu), float(wd), int(bool(sr)))
    with torch.cuda.device(out.device):
        rc = fn(*args, out.numel(), part.shape[0], *tail, _stream(out))
    _build.check(lib, rc, f"{what} launch")
    return out


def fwd_merge(part, out):
    """The merge of a split K13/K16 launch (``_merge``); a launch counts in
    ``fwd_merge_launches``."""
    global fwd_merge_launches
    _merge("fwd_merge", part, out)
    if out.device.type != "cpu":
        fwd_merge_launches += 1
    return out


def dx_merge(part, out):
    """The merge of a split K14/K17 launch (``_merge``); a launch counts in
    ``dx_merge_launches``."""
    global dx_merge_launches
    _merge("dx_merge", part, out)
    if out.device.type != "cpu":
        dx_merge_launches += 1
    return out


def dw_merge(part, mask, out):
    """The merge of a split K15/K18 launch (``_merge`` with the wgrad's
    mask: the ordered sum, then times the mask, one rounding); a launch
    counts in ``dw_merge_launches``."""
    global dw_merge_launches
    _merge("dw_merge", part, out, mask)
    if out.device.type != "cpu":
        dw_merge_launches += 1
    return out


def dw_fused_merge(part, wgm, w, mom, out, seed: int, *, mu: float, wd: float, sr: bool):
    """The merge of a split K19/K20 launch (``_merge`` with the momentum
    epilogue: the ordered sum, then ``(mu * mom + sum + wd * w) * wgm``, sr
    on the element ids of out's shape, one rounding to out.dtype); a launch
    counts in ``dw_fused_merge_launches``."""
    global dw_fused_merge_launches
    _merge("dw_fused_merge", part, out, wgm, (w, mom, seed, mu, wd, sr))
    if out.device.type != "cpu":
        dw_fused_merge_launches += 1
    return out


def _gemm(entry, what, s, a, b, mask, G, rows, L, cols, bn_limit, plan, fused=None,
          out_dtype=None):
    """One GEMM-core launch, out (G, rows, cols) in ``out_dtype`` (default
    a.dtype), with the merge after a split (G = 1 for K13-K15, K19):
    ``entry`` "fwd" (K13/K16: a = x (G, M, K), b = w; rows = M, L = K, cols
    = N), "dx" (K14/K17: a = g (G, M, N), b = w; rows = M, L = N, cols =
    K), "dw" (K15/K18: a = x (G, M, K), b = g (G, M, N); rows = K, L = M,
    cols = N) or "dw_fused" (K19/K20: as "dw", with ``fused`` = (w, mom,
    seed, mu, wd, sr) the new momentum, ``s`` the entry's <T>_<mom>_<out>
    suffix); w and mask (G, K, N)."""
    kinds = () if fused is None else (fused[1].dtype, out_dtype or a.dtype)
    bm, bn, n_split = plan or _fwd_plan_for(rows, L, cols, G, a.dtype, bn_limit,
                                            a.device.index, entry, *kinds)
    tiles = DW_TILES if entry in WGRADS else FWD_TILES
    if (bm, bn) not in tiles or not 1 <= n_split <= -(-L // FWD_SLAB):
        raise ValueError(f"{what}: plan {(bm, bn, n_split)} is not a built tile "
                         f"{tiles} with 1 <= n_split <= ceil({L} / {FWD_SLAB})")
    out = torch.empty(G, rows, cols, dtype=out_dtype or a.dtype, device=a.device)
    part = (torch.empty(n_split, G, rows, cols, dtype=torch.float32, device=a.device)
            if n_split > 1 else None)
    # the C entries take (G, M, K, N)
    dims = (L, rows, cols) if entry in WGRADS else {"fwd": (rows, L, cols),
                                                    "dx": (rows, cols, L)}[entry]
    ptrs, tail = [a.data_ptr(), b.data_ptr(), mask.data_ptr()], ()
    if fused is not None:
        w, mom, seed, mu, wd, sr = fused
        ptrs += [w.data_ptr(), mom.data_ptr()]
        tail = (int(seed) & _M32, float(mu), float(wd), int(bool(sr)))
    lib, fn = _fn(f"masked_{entry}_{s}", [_P] * (len(ptrs) + 2) + [_I] * 7
                  + (list(_FUSED_TAIL) if tail else []) + [_P])
    with torch.cuda.device(a.device):
        rc = fn(*ptrs, out.data_ptr(), None if part is None else part.data_ptr(), G, *dims,
                bm, bn, n_split, *tail, _stream(a))
    _build.check(lib, rc, f"{what} launch")
    if part is not None:
        if entry == "dw_fused":
            dw_fused_merge(part, mask.view(out.shape), w.view(out.shape), mom.view(out.shape),
                           out, seed, mu=mu, wd=wd, sr=sr)
        elif entry == "dw":
            dw_merge(part, mask.view(out.shape), out)
        else:
            (fwd_merge if entry == "fwd" else dx_merge)(part, out)
    return out


def fused_error_bound(out_plain, abs_prod, n: int, mu: float, wd: float, mom, w,
                      acc_plain, wgm):
    """Per-element bound on |K19 - plain| without ``sr``: the two x^T @ g
    sums differ by ``matmul_error_bound`` at most; the epilogue's three f32
    additions and products round on each side at partial sums no larger
    than |mu mom| + |acc| + |wd w|, one 2**-24 relative each, a bf16 output
    one rounding more (inside ``matmul_error_bound``)."""
    m = wgm.float()
    epi = (mu * mom.float()).abs() + acc_plain.float().abs() + (wd * w.float()).abs()
    return matmul_error_bound(out_plain, abs_prod * m, n) + 8 * 2.0**-24 * epi * m


def _check_cuda(what, dense, masks, blocks, tiles, same):
    """Device, dtype, mask type, contiguity, tiling and alignment of one
    launch: ``dense`` the float operands, ``masks`` the bool ones; ``tiles``
    (extent, block) pairs that must divide, ``same`` (extent, extent) pairs
    that must be equal."""
    dev = dense[0].device
    for t in (*dense, *masks):
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
    suffix = _suffix(what, *dense)
    if any(m.dtype != torch.bool for m in masks):
        raise TypeError(f"{what}: masks must be bool")
    if not all(t.is_contiguous() for t in (*dense, *masks)):
        raise ValueError(f"{what}: inputs must be contiguous")
    for name, blk in blocks.items():
        if blk % 16 or not 16 <= blk <= 128:
            raise ValueError(f"{what}: {name}={blk} must be a multiple of 16 in [16, 128]")
    if any(e % blk for e, blk in tiles) or any(e != f for e, f in same):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in dense]} do not "
                         f"match or do not tile by the blocks {blocks} (K and N "
                         "must be multiples of 16)")
    if any(t.data_ptr() % 16 for t in (*dense, *masks)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return suffix


def _fn(name: str, argtypes, lib_name: str = "masked_matmul"):
    lib = _build.load(lib_name)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = _I
    return lib, fn


def _device(what, t):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def masked_matmul(x, w, mask, *, bm: int, bn: int, plan=None):
    """K13: x (M, K) @ (w * mask) (K, N) -> (M, N) in x.dtype.  M must be a
    multiple of the caller's row tile ``bm`` (``kernels/ops.py`` pads
    rows); ``bn`` caps the column tile (``fwd_tile``).  ``fwd_plan`` picks
    the launch, or ``plan`` = (bm, bn, n_split) forces one (one of
    ``FWD_TILES``).  CUDA tensors run the kernel or raise; CPU tensors run
    the plain version."""
    global launches
    if x.device.type == "cpu":
        return masked_matmul_plain(x, w, mask)
    _device("masked_matmul", x)
    (M, K), N = x.shape, w.shape[1]
    s = _check_cuda("masked_matmul", (x, w), (mask,), {"bm": bm, "bn": bn},
                    [(M, bm), (N, bn), (K, 16)], [(w.shape[0], K), (mask.shape, w.shape)])
    y = _gemm("fwd", "masked_fwd", s, x, w, mask, 1, M, K, N, bn, plan)
    launches += 1
    return y[0]


def grouped_masked_matmul(x, w, mask, *, bm: int, bn: int, plan=None):
    """K16: x (G, M, K) @ (w * mask) (G, K, N) -> (G, M, N) in x.dtype,
    every group in one launch.  M must be a multiple of ``bm``
    (``kernels/ops.py`` pads rows); ``bn`` and ``plan`` as for
    ``masked_matmul``.  CUDA tensors run the kernel or raise; CPU tensors
    run the plain version."""
    global g_launches
    if x.device.type == "cpu":
        return grouped_masked_matmul_plain(x, w, mask)
    _device("grouped_masked_matmul", x)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_masked_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be (G, M, K) and (G, K, N)")
    (G, M, K), N = x.shape, w.shape[2]
    s = _check_cuda("grouped_masked_matmul", (x, w), (mask,), {"bm": bm, "bn": bn},
                    [(M, bm), (N, bn), (K, 16)],
                    [(w.shape[0], G), (w.shape[1], K), (mask.shape, w.shape)])
    y = _gemm("fwd", "masked_fwd_grouped", s, x, w, mask, G, M, K, N, bn, plan)
    g_launches += 1
    return y


def masked_dx(g, w, mask, *, bm: int, bk: int, plan=None):
    """K14: g (M, N) @ (w * mask)^T -> dx (M, K) in g.dtype; M a multiple
    of ``bm``; ``bk`` caps the column tile (``fwd_tile``).  ``fwd_plan``
    picks the launch (rows M, contraction N, columns K), or ``plan`` = (bm,
    bn, n_split) forces one (one of ``FWD_TILES``).  CUDA tensors run the
    kernel or raise; CPU tensors run the plain version."""
    global dx_launches
    if g.device.type == "cpu":
        return masked_dx_plain(g, w, mask)
    _device("masked_dx", g)
    (M, N), K = g.shape, w.shape[0]
    s = _check_cuda("masked_dx", (g, w), (mask,), {"bm": bm, "bk": bk},
                    [(M, bm), (K, bk), (N, 16)], [(w.shape[1], N), (mask.shape, w.shape)])
    dx = _gemm("dx", "masked_dx", s, g, w, mask, 1, M, N, K, bk, plan)
    dx_launches += 1
    return dx[0]


def _check_grouped(what, a, b, mask):
    if a.dim() != 3 or b.dim() != 3 or mask.dim() != 3 or b.shape[0] != a.shape[0]:
        raise ValueError(f"{what}: operands {tuple(a.shape)}, {tuple(b.shape)} and "
                         f"mask {tuple(mask.shape)} must be 3-D with one group dim")


def grouped_masked_dx(g, w, mask, *, bm: int, bk: int, plan=None):
    """K17: g (G, M, N) @ (w * mask) (G, K, N)^T -> dx (G, M, K) in g.dtype,
    every group in one launch; M a multiple of ``bm``; ``bk`` and ``plan``
    as for ``masked_dx``.  CUDA tensors run the kernel or raise; CPU
    tensors run the plain version."""
    global gdx_launches
    if g.device.type == "cpu":
        return grouped_masked_dx_plain(g, w, mask)
    _device("grouped_masked_dx", g)
    _check_grouped("grouped_masked_dx", g, w, mask)
    (G, M, N), K = g.shape, w.shape[1]
    s = _check_cuda("grouped_masked_dx", (g, w), (mask,), {"bm": bm, "bk": bk},
                    [(M, bm), (K, bk), (N, 16)],
                    [(w.shape[2], N), (mask.shape, w.shape)])
    dx = _gemm("dx", "masked_dx_grouped", s, g, w, mask, G, M, N, K, bk, plan)
    gdx_launches += 1
    return dx


def grouped_masked_dw(x, g, mask, *, bn: int, bk: int, plan=None):
    """K18: dw (G, K, N) = (x[g]^T @ g[g]) * mask[g] in x.dtype, every group
    in one launch; x (G, M, K), g (G, M, N), M a multiple of 16
    (``kernels/ops.py`` pads rows); ``bn`` and ``plan`` as for
    ``masked_dw``.  CUDA tensors run the kernel or raise; CPU tensors run
    the plain version."""
    global gdw_launches
    if x.device.type == "cpu":
        return grouped_masked_dw_plain(x, g, mask)
    _device("grouped_masked_dw", x)
    _check_grouped("grouped_masked_dw", x, g, mask)
    (G, M, K), N = x.shape, g.shape[2]
    s = _check_cuda("grouped_masked_dw", (x, g), (mask,), {"bn": bn, "bk": bk},
                    [(M, 16), (K, bk), (N, bn)],
                    [(g.shape[1], M), (mask.shape, (G, K, N))])
    dw = _gemm("dw", "masked_dw_grouped", s, x, g, mask, G, K, M, N, bn, plan)
    gdw_launches += 1
    return dw


def _dw_checks(what, x, g, masks, bn, bk):
    (M, K), N = x.shape, g.shape[1]
    return _check_cuda(what, (x, g), masks, {"bn": bn, "bk": bk},
                       [(M, 16), (K, bk), (N, bn)],
                       [(g.shape[0], M)] + [(m.shape, (K, N)) for m in masks])


def masked_dw(x, g, mask, *, bn: int, bk: int, plan=None):
    """K15: dw (K, N) = (x^T @ g) * mask in x.dtype; x (M, K), g (M, N), M
    a multiple of 16 (``kernels/ops.py`` pads rows), K a multiple of
    ``bk``; ``bn`` caps the column tile (``fwd_tile``).  ``fwd_plan`` picks
    the launch (rows K, contraction M, columns N), or ``plan`` = (bm, bn,
    n_split) forces one (one of ``DW_TILES``).  CUDA tensors run the
    kernel or raise; CPU tensors run the plain version."""
    global dw_launches
    if x.device.type == "cpu":
        return masked_dw_plain(x, g, mask)
    _device("masked_dw", x)
    (M, K), N = x.shape, g.shape[1]
    s = _dw_checks("masked_dw", x, g, (mask,), bn, bk)
    dw = _gemm("dw", "masked_dw", s, x, g, mask, 1, K, M, N, bn, plan)
    dw_launches += 1
    return dw[0]


def masked_dw_fused(x, g, wgm, w, mom, seed: int, *, mu: float, wd: float, sr: bool,
                    bn: int, bk: int, out_dtype=None, plan=None):
    """K19: the new SGD momentum ``(mu * mom + x^T @ g + wd * w) * wgm``
    (K, N) in ``out_dtype`` (default w.dtype), stochastically rounded onto
    the bf16 grid when ``sr`` with the uint32 ``seed``.  x (M, K), g (M,
    N), w (K, N) of one dtype; mom bf16 or f32; M a multiple of 16, K of
    ``bk``; ``bn`` caps the column tile.  ``fwd_plan`` picks the launch on
    the fused kernel's own slots (rows K, contraction M, columns N), or
    ``plan`` = (bm, bn, n_split) forces one (one of ``DW_TILES``); a split
    is merged by ``dw_fused_merge``.  CUDA tensors run the kernel or raise;
    CPU tensors run the plain version."""
    global fused_launches
    out_dtype = out_dtype or w.dtype
    if x.device.type == "cpu":
        return masked_dw_fused_plain(x, g, wgm, w, mom, seed, mu=mu, wd=wd, sr=sr,
                                     out_dtype=out_dtype)
    _device("masked_dw_fused", x)
    (M, K), N = x.shape, g.shape[1]
    s = _dw_checks("masked_dw_fused", x, g, (wgm,), bn, bk)
    e = _fused_entry_name("masked_dw_fused", s, (K, N), x, w, mom, out_dtype)
    out = _gemm("dw_fused", "masked_dw_fused", e, x, g, wgm, 1, K, M, N, bn, plan,
                (w, mom, seed, mu, wd, sr), out_dtype)
    fused_launches += 1
    return out[0]


def grouped_masked_dw_fused(x, g, wgm, w, mom, seed: int, *, mu: float, wd: float,
                            sr: bool, bn: int, bk: int, out_dtype=None, plan=None):
    """K20: K19 for every group of a bank in one launch: the new momentum
    ``(mu * mom + x^T @ g + wd * w) * wgm`` (G, K, N) in ``out_dtype``
    (default w.dtype), sr ids (g * K + row) * N + col.  x (G, M, K), g (G,
    M, N), wgm, w and mom (G, K, N); M a multiple of 16; ``bn`` and
    ``plan`` as for ``masked_dw_fused``.  CUDA tensors run the kernel or
    raise; CPU tensors run the plain version."""
    global g_fused_launches
    out_dtype = out_dtype or w.dtype
    if x.device.type == "cpu":
        return grouped_masked_dw_fused_plain(x, g, wgm, w, mom, seed, mu=mu, wd=wd, sr=sr,
                                             out_dtype=out_dtype)
    _device("grouped_masked_dw_fused", x)
    _check_grouped("grouped_masked_dw_fused", x, g, wgm)
    (G, M, K), N = x.shape, g.shape[2]
    s = _check_cuda("grouped_masked_dw_fused", (x, g), (wgm,), {"bn": bn, "bk": bk},
                    [(M, 16), (K, bk), (N, bn)],
                    [(g.shape[1], M), (wgm.shape, (G, K, N))])
    e = _fused_entry_name("grouped_masked_dw_fused", s, (G, K, N), x, w, mom, out_dtype)
    out = _gemm("dw_fused", "masked_dw_fused_grouped", e, x, g, wgm, G, K, M, N, bn, plan,
                (w, mom, seed, mu, wd, sr), out_dtype)
    g_fused_launches += 1
    return out


class MaskedMatmul(torch.autograd.Function):
    """y = x @ (w * m); backward dx (K14) and dw (K15) on the same mask, as
    the reference's ``_mm_fwd/_mm_bwd``.  The mask gets no gradient."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, mask, bm, bn, bk):
        ctx.save_for_backward(x, w, mask)
        ctx.blocks = (bm, bn, bk)
        return masked_matmul(x, upcast(w, x), mask, bm=bm, bn=bn)

    @staticmethod
    def backward(ctx, g):
        x, w, mask = ctx.saved_tensors
        return _backward(ctx, g, x, w, mask, mask) + (None,) * 4


class TopkastMaskedMatmul(torch.autograd.Function):
    """Forward and dx on the forward mask A, dw on the Top-KAST superset
    B ⊇ A, as the reference's ``_tkm_fwd/_tkm_bwd``: dw is the dense
    gradient restricted to B."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, mask, bwd_mask, bm, bn, bk):
        ctx.save_for_backward(x, w, mask, bwd_mask)
        ctx.blocks = (bm, bn, bk)
        return masked_matmul(x, upcast(w, x), mask, bm=bm, bn=bn)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, *ctx.saved_tensors) + (None,) * 5


class FusedMaskedMatmul(torch.autograd.Function):
    """``MaskedMatmul`` whose weight cotangent IS the new SGD momentum
    ``(mu * mom + x^T @ g + wd * w) * wgm`` (K19), as the reference's
    ``_fmm_fwd/_fmm_bwd``; mom's cotangent is a discarded zero (None)."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, mask, wgm, mom, seed, mu, wd, sr, bm, bn, bk):
        ctx.save_for_backward(x, w, mask, wgm, mom)
        ctx.blocks = (bm, bn, bk)
        ctx.epilogue = dict(seed=int(seed), mu=float(mu), wd=float(wd), sr=bool(sr))
        return masked_matmul(x, upcast(w, x), mask, bm=bm, bn=bn)

    @staticmethod
    def backward(ctx, g):
        x, w, mask, wgm, mom = ctx.saved_tensors
        return _backward(ctx, g, x, w, mask, wgm, mom=mom) + (None,) * 10


class GroupedMaskedMatmul(torch.autograd.Function):
    """y[g] = x[g] @ (w[g] * m[g]) over a weight bank (K16); backward dx
    (K17) and dw (K18) on the same mask, as the reference's
    ``_gmm_fwd/_gmm_bwd``."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, mask, bm, bn, bk):
        ctx.save_for_backward(x, w, mask)
        ctx.blocks = (bm, bn, bk)
        return grouped_masked_matmul(x, upcast(w, x), mask, bm=bm, bn=bn)

    @staticmethod
    def backward(ctx, g):
        x, w, mask = ctx.saved_tensors
        return _backward(ctx, g, x, w, mask, mask, grouped=True) + (None,) * 4


class TopkastGroupedMaskedMatmul(torch.autograd.Function):
    """The grouped Top-KAST split, as the reference's ``_gtkm_fwd/_gtkm_bwd``:
    forward (K16) and dx (K17) on the forward mask A, dw (K18) on the
    superset B ⊇ A."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, mask, bwd_mask, bm, bn, bk):
        ctx.save_for_backward(x, w, mask, bwd_mask)
        ctx.blocks = (bm, bn, bk)
        return grouped_masked_matmul(x, upcast(w, x), mask, bm=bm, bn=bn)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, *ctx.saved_tensors, grouped=True) + (None,) * 5


class FusedGroupedMaskedMatmul(torch.autograd.Function):
    """``GroupedMaskedMatmul`` whose weight cotangent IS the new SGD
    momentum ``(mu * mom + x^T @ g + wd * w) * wgm`` per group (K20), as
    the reference's ``_gfmm_fwd/_gfmm_bwd``: forward K16, dx K17 on the
    forward mask; mom's cotangent is a discarded zero (None)."""

    @staticmethod
    @opaque
    def forward(ctx, x, w, mask, wgm, mom, seed, mu, wd, sr, bm, bn, bk):
        ctx.save_for_backward(x, w, mask, wgm, mom)
        ctx.blocks = (bm, bn, bk)
        ctx.epilogue = dict(seed=int(seed), mu=float(mu), wd=float(wd), sr=bool(sr))
        return grouped_masked_matmul(x, upcast(w, x), mask, bm=bm, bn=bn)

    @staticmethod
    def backward(ctx, g):
        x, w, mask, wgm, mom = ctx.saved_tensors
        return _backward(ctx, g, x, w, mask, wgm, mom=mom, grouped=True) + (None,) * 10


def _backward(ctx, g, x, w, mask, dmask, mom=None, grouped=False):
    """dx on ``mask`` and dw on ``dmask``: K14/K15, or K17/K18 for a bank;
    with ``mom`` the weight cotangent is the fused epilogue's new momentum
    masked by ``dmask`` (K19, or K20).  A narrower w (a bf16 master under
    f32 compute) is upcast for its launch only and its cotangent rounded
    once to w.dtype (``block_sparse_matmul.upcast``)."""
    bm, bn, bk = ctx.blocks
    dx_fn, dw_fn, fused_fn = (
        (grouped_masked_dx, grouped_masked_dw, grouped_masked_dw_fused) if grouped
        else (masked_dx, masked_dw, masked_dw_fused))
    g = g.contiguous()
    dx = dx_fn(g, upcast(w, x), mask, bm=bm, bk=bk) if ctx.needs_input_grad[0] else None
    dw = None
    if ctx.needs_input_grad[1]:
        dw = (dw_fn(x, g, dmask, bn=bn, bk=bk) if mom is None
              else fused_fn(x, g, dmask, upcast(w, x), mom, bn=bn, bk=bk, **ctx.epilogue))
        dw = dw.to(w.dtype)
    return dx, dw
