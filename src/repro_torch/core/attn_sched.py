"""AttnSchedule — host-built KV-block schedules for tight flash-attention grids.

Own copy (numpy only) of the JAX package's ``core/attn_sched.py``: the
arrays must be equal element by element, since the flash kernel of each
package walks exactly ``kv_idx[qb, :kv_cnt[qb]]``.  The paged-prefix
schedule (``paged_prefix_schedule``) is copied too; the brute-force
rasterizer is not ported.

The flash-attention kernel (kernels/flash_attention.py) tiles the score matrix
into (bq x bk) blocks.  For causal and sliding-window masks most of those
blocks are DEAD — every (q, k) position inside them is masked — yet a dense
grid still launches (and DMAs K/V for) all of them: at Sk = 32k with a 512
window, >90% of the score grid is dead work.  This module is the attention
twin of core/pack.py: the set of LIVE KV blocks per query-block row is known
STATICALLY (it depends only on shapes, block sizes and the mask family — never
on data), so it is rasterized host-side into a CSR-style schedule

  {"kv_idx": (n_q, width) int32,   # live KV-block ids per q-block, ascending
   "kv_cnt": (n_q,) int32,         #   -> drives the fwd and dq kernel grids
   "q_idx":  (n_k, q_width) int32, # reverse view: live q-blocks per KV-block
   "q_cnt":  (n_k,) int32,         #   -> drives the dk/dv kernel grid
   "n_live": () int32,             # total live score blocks
   "n_q/n_k/bq/bk/...": python ints/bools (static metadata, see below)}

and the flash kernel's loop over KV blocks walks ``kv_idx[qb, :kv_cnt[qb]]``
instead of all n_k blocks.

Unlike PackState, a schedule is DERIVED state with no lifecycle: it never
refreshes (RigL moves weight topology, not mask geometry) and depends only
on shapes.  ``sched_for`` memoizes builds per (Sq, Sk, bq, bk, causal,
window, q_offset).

Position convention: key/value column c sits at absolute position c; query
row r sits at position ``q_offset + r``.  ``q_offset=None`` defaults to
Sk - Sq (decode-style right alignment: the last query sees every key), which
reduces to 0 for the ubiquitous Sq == Sk case.  This matches the offset
arithmetic of models/attention.py::_make_mask.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np

__all__ = ["live_block_mask", "build_attn_schedule", "sched_for",
           "paged_prefix_schedule"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def live_block_mask(
    sq: int,
    sk: int,
    bq: int,
    bk: int,
    *,
    causal: bool,
    window: int = 0,
    q_offset: Optional[int] = None,
) -> np.ndarray:
    """(n_q, n_k) bool: block (i, j) is live iff ANY (q, k) inside it is
    unmasked.  Computed analytically from block position ranges — O(n_q*n_k),
    no (Sq, Sk) rasterization, so 500k-token schedules stay cheap.

    A block straddling the valid-key boundary (sk not a bk multiple) counts as
    live when its in-range columns are; columns >= sk are masked in-kernel.
    """
    if q_offset is None:
        q_offset = sk - sq
    n_q, n_k = _cdiv(sq, bq), _cdiv(sk, bk)
    i = np.arange(n_q)
    j = np.arange(n_k)
    # absolute position extremes of each block's VALID rows/cols
    q_lo = (q_offset + i * bq)[:, None]  # (n_q, 1)
    q_hi = (q_offset + np.minimum((i + 1) * bq, sq) - 1)[:, None]
    k_lo = (j * bk)[None, :]  # (1, n_k)
    k_hi = np.minimum((j + 1) * bk, sk)[None, :] - 1
    live = np.ones((n_q, n_k), bool)
    if causal:
        live &= k_lo <= q_hi  # some key at or below some query position
    if window:
        live &= k_hi > q_lo - window  # some key inside the oldest row's window
    return live


def _pack_rows(live: np.ndarray):
    """(R, C) bool -> (idx (R, width) int32, cnt (R,) int32): per-row active
    column ids, ascending, padded slots 0.  Same stable-argsort packing as
    kernels/block_sparse_matmul.py::_pack_np, transposed to the row view."""
    cnt = live.sum(axis=1).astype(np.int32)
    width = max(int(cnt.max(initial=0)), 1)
    order = np.argsort(~live, axis=1, kind="stable")
    idx = order[:, :width].astype(np.int32)
    idx = np.where(np.arange(width)[None, :] < cnt[:, None], idx, 0)
    return idx, cnt


def build_attn_schedule(
    sq: int,
    sk: int,
    bq: int,
    bk: int,
    *,
    causal: bool,
    window: int = 0,
    q_offset: Optional[int] = None,
) -> dict[str, Any]:
    """Host-build the schedule dict for one (shape, mask-family) combination.

    ``kv_idx``/``kv_cnt`` drive the forward and dq grids (per q-block, its
    live KV blocks); ``q_idx``/``q_cnt`` are the transpose view driving the
    dk/dv grid (per KV-block, its live q blocks) — the same CSC/CSR duality as
    the weight packs in core/pack.py.  Static metadata (block sizes, mask
    family, offsets) rides along so the kernel wrapper never re-derives it.

    Degenerate inputs are first-class: window >= sk reduces to the pure-causal
    schedule, window < bk still keeps >= 1 live block per row (the diagonal),
    and sq = 1 (decode) yields the single-row schedule over the window's tail.
    """
    if q_offset is None:
        q_offset = sk - sq
    live = live_block_mask(
        sq, sk, bq, bk, causal=causal, window=window, q_offset=q_offset
    )
    kv_idx, kv_cnt = _pack_rows(live)
    q_idx, q_cnt = _pack_rows(live.T)
    # numpy leaves: ``sched_for`` memoizes builds, and the kernel wrapper
    # copies the two arrays it needs to the device of each call.
    return {
        "kv_idx": kv_idx,
        "kv_cnt": kv_cnt,
        "q_idx": q_idx,
        "q_cnt": q_cnt,
        "n_live": int(live.sum()),
        # static metadata (python scalars — hashable, never traced)
        "sq": sq,
        "sk": sk,
        "bq": bq,
        "bk": bk,
        "causal": bool(causal),
        "window": int(window),
        "q_offset": int(q_offset),
    }


@functools.lru_cache(maxsize=256)
def sched_for(
    sq: int,
    sk: int,
    bq: int,
    bk: int,
    causal: bool,
    window: int = 0,
    q_offset: Optional[int] = None,
):
    """Memoized ``build_attn_schedule``: schedules are pure functions of
    shapes, so a prefill length builds its schedule once per process."""
    return build_attn_schedule(
        sq, sk, bq, bk, causal=causal, window=window, q_offset=q_offset
    )


@functools.lru_cache(maxsize=256)
def paged_prefix_schedule(sq: int, n_pages: int, bq: int, page_size: int):
    """Walk of the paged-prefix phase of a suffix prefill (the reference's
    ``paged_prefix_schedule``).  Page liveness depends on the per-row
    prefix length ``ctx``, which the host schedule does not know, so
    ``kv_idx`` is the identity walk over all ``n_pages`` table entries for
    every q-block; the kernel clips it at ``ceil(ctx / page_size)`` pages."""
    n_q = _cdiv(sq, bq)
    kv_idx = np.broadcast_to(
        np.arange(n_pages, dtype=np.int32)[None, :], (n_q, n_pages)
    ).copy()
    return {
        "sq": sq,
        "n_pages": n_pages,
        "bq": bq,
        "page_size": page_size,
        "width": n_pages,
        "kv_idx": kv_idx,
    }
