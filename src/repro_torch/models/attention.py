"""GQA attention of the port: RoPE, sliding window, flash prefill, KV-cache
decode, paged KV pools.

Port of the JAX package's ``models/attention.py`` for serving.  Prefill
attention with ``attn_kernel`` 'flash' or 'flash_tight' runs the flash
kernel (``kernels/flash_attention.py``), which walks the AttnSchedule of
the prompt length; 'dense' runs the plain masked softmax.  Decode
attention is plain PyTorch, as it is plain jnp in the reference: one query
per slot over the window-bounded cache has no dead score block to skip.

Paged caches (``init_kv_pool``): one pool of (N, page_size, KV, hd) pages
per layer, addressed through per-slot block tables whose unowned entries
hold the sentinel id N.  The reference's XLA gathers clip N and its
scatters drop it (``mode='drop'``); torch indexing has neither, so reads
clamp the table to N - 1 and writes go through ``_scatter_drop``, which
never indexes with N and needs no host sync.  A suffix prefill over a
cached prefix (``attention(history=)``) runs the paged flash kernel K12 for
the prefix and the causal flash kernel K9 for the suffix, merged by
logsumexp as in the reference.

Caches are updated in place (the reference returns new arrays): the serving
engine owns one batched cache for its lifetime, and in-place writes keep a
second copy of it from existing during every step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.flash_attention import flash_attention, flash_attention_paged
from . import tp
from .layers import P, compute_dtype, linear, rmsnorm, rmsnorm_init

__all__ = [
    "attn_init",
    "attention",
    "attn_decode",
    "fill_kv_cache",
    "fill_kv_pool",
    "fill_kv_pool_suffix",
    "gather_kv_pool",
    "init_kv_cache",
    "init_kv_pool",
    "rope",
]

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def _fan_in(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device) / np.sqrt(shape[0])


def attn_init(gen, cfg, *, sparse: bool = True):
    """The four projections; under ``cfg.qk_norm`` also the dense
    ``q_norm``/``k_norm`` scales over head_dim."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": {"w": P(_fan_in(gen, (d, H * hd)), ("embed", "heads"), sparse)},
        "wk": {"w": P(_fan_in(gen, (d, KV * hd)), ("embed", "kv_heads"), sparse)},
        "wv": {"w": P(_fan_in(gen, (d, KV * hd)), ("embed", "kv_heads"), sparse)},
        "wo": {"w": P(_fan_in(gen, (H * hd, d)), ("heads", "embed"), sparse)},
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, gen.device, ("head_dim",))
        p["k_norm"] = rmsnorm_init(hd, gen.device, ("head_dim",))
    return p


@functools.lru_cache(maxsize=None)
def _rope_freqs(hd: int, theta: float, device: torch.device):
    """The reference's float64 numpy frequencies in f32, copied to the
    device once: a host-to-device copy per call would synchronise the
    stream in every layer of every decode step."""
    half = hd // 2
    return torch.tensor(1.0 / (theta ** (np.arange(0, half) / half)),
                        dtype=torch.float32, device=device)


def rope(x, positions, theta: float = 1e4):
    """x: (..., S, n, hd); positions: (S,) or (B, S).  Angles and the
    rotation in f32, the result in x.dtype (as the reference)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    pos = torch.as_tensor(positions, device=x.device).float()
    ang = pos[..., None] * freqs  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _linear_kw(cfg, masks, name, pack=None):
    return dict(
        mask=None if masks is None else masks[name]["w"],
        kernel=cfg.sparse.kernel,
        block=cfg.sparse.kernel_block,
        pack=None if pack is None else pack[name]["w"],
    )


def parallel(p, cfg) -> bool:
    """Does this rank hold a shard of the q heads (tensor parallelism over
    ``model``: ``models/tp.py``)?  The head counts come from the weights'
    shapes: ``wq`` holds this rank's heads, ``wk``/``wv`` its kv heads, or
    all of them where the kv heads do not divide the axis (or their shard
    would split a weight block)."""
    hd = cfg.head_dim
    par = tp.shards(p["wq"]["w"].shape[-1] // hd, cfg.n_heads)
    if not par and tp.shards(p["wk"]["w"].shape[-1] // hd, cfg.n_kv_heads):
        raise NotImplementedError(
            f"config {cfg.name!r} on model={tp.size()}: kv heads sharded with the q heads "
            "whole")
    return par


def _kv_heads_read(cfg) -> tuple[int, int]:
    """[k0, k1) of the kv heads this rank's q heads read (kv head h // G)
    when every rank holds all of them."""
    G = cfg.n_heads // cfg.n_kv_heads
    lo, hi = tp.local_range(cfg.n_heads)
    if (hi - lo) % G and G % (hi - lo):
        raise NotImplementedError(
            f"config {cfg.name!r} on model={tp.size()}: {hi - lo} q heads a rank straddle "
            f"groups of {G}")
    return lo // G, (hi - 1) // G + 1


def _qkv(p, x, cfg, masks=None, pack=None):
    """q, k, v (B, S, heads, hd) of this rank's heads.  Under tensor
    parallelism x enters through ``copy_to_model``; kv weights every rank
    holds whole (and the qk-norm scales) are read inside the parallel
    region, so they enter through it too (their gradient is summed over
    the model ranks), and k, v keep the kv heads this rank's q heads read."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    dt = compute_dtype(cfg)
    par = parallel(p, cfg)
    kv_whole = par and p["wk"]["w"].shape[-1] == cfg.n_kv_heads * hd
    inner = tp.copy_to_model if par else (lambda t: t)
    kv_w = tp.copy_to_model if kv_whole else (lambda t: t)
    x = inner(x)
    q = linear(p["wq"], x, dt, **_linear_kw(cfg, masks, "wq", pack)).reshape(B, S, -1, hd)
    k = linear({"w": kv_w(p["wk"]["w"])}, x, dt,
               **_linear_kw(cfg, masks, "wk", pack)).reshape(B, S, -1, hd)
    v = linear({"w": kv_w(p["wv"]["w"])}, x, dt,
               **_linear_kw(cfg, masks, "wv", pack)).reshape(B, S, -1, hd)
    if kv_whole:
        k0, k1 = _kv_heads_read(cfg)
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    if cfg.qk_norm:  # over head_dim, before RoPE, at rmsnorm's own eps (1e-6)
        q = rmsnorm({"scale": inner(p["q_norm"]["scale"])}, q)
        k = rmsnorm({"scale": inner(p["k_norm"]["scale"])}, k)
    return q, k, v


def _scores(q, k, cfg):
    """q: (B, Sq, KV, G, hd); k: (B, Sk, KV, hd) -> (B, KV, G, Sq, Sk) in
    f32, or in bf16 when ``cfg.attn_scores_dtype == "bfloat16"``.  q is
    scaled in its own dtype first, as in the reference.  The bf16 scores
    are the f32-accumulated product rounded once to bf16 (the reference's
    ``preferred_element_type=bf16``); the softcap then runs in bf16."""
    q = q * float(1.0 / np.sqrt(cfg.head_dim))
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    if cfg.attn_scores_dtype == "bfloat16":
        s = s.to(torch.bfloat16)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        s = c * torch.tanh(s / c)
    return s


def _softmax_attend(q, k, v, valid, cfg):
    """Masked softmax attention; valid broadcasts against (B, KV, G, Sq, Sk).
    The mask and softmax run in the scores' dtype (``_scores``), and the
    weights are cast to v.dtype before the value product."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    s = _scores(q.reshape(B, Sq, KV, H // KV, hd), k, cfg)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    if s.dtype == torch.bfloat16:
        # jax.nn.softmax's ops, each rounded to bf16 as in the reference
        e = torch.exp(s - s.amax(-1, keepdim=True))
        w = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    else:
        w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w.float(), v.float()).to(v.dtype)
    return o.reshape(B, Sq, H, hd)


def _make_mask(sq, sk, causal, window, device):
    if not causal and not window:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _flash_attend(q, k, v, cfg, *, causal, window):
    """(B, S, H, hd) GQA heads -> flash layout (B*H, S, hd) and back; K/V
    stay at their KV-head count and the kernel reads row b // G."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    fold = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, hd)
    o = flash_attention(
        fold(q), fold(k), fold(v), causal=causal, window=window,
        softcap=float(cfg.logit_softcap or 0.0), kv_groups=H // KV,
    )
    return o.reshape(B, H, S, hd).transpose(1, 2)


def attention(p, x, cfg, *, kind: str = "global", positions=None, masks=None,
              pack=None, history=None, reduce: bool = True):
    """Full-sequence attention (prefill).  Returns (out, (k, v)).

    kind: 'global' or 'local' (sliding window ``cfg.window``).  ``masks`` /
    ``pack`` route the projections through ``layers.linear``.

    Under tensor parallelism (``parallel``) this rank runs its heads (q,
    k, v column-parallel, the flash kernels on the local heads with G
    unchanged) and ``wo`` row-parallel: its output is summed over the model
    ranks, unless ``reduce`` is False (a parallel block sums it with the
    FFN's partial once).

    history: suffix-only prefill over a paged prefix, as the reference:
    {"pool": init_kv_pool leaves, "table": (B, T) int32 page ids, "ctx":
    (B,) int32 valid prefix lengths on x's device}.  ``x`` is then the
    suffix (``positions`` carry its absolute offsets) and every query also
    attends the first ``ctx`` cached positions.  Global causal layers only.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, masks, pack)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else 0
    attn_kernel = cfg.sparse.attn_kernel
    if attn_kernel not in ("dense", "flash", "flash_tight"):
        raise ValueError(f"unknown sparse.attn_kernel {attn_kernel!r}")
    if history is not None:
        if kind != "global" or window or not cfg.causal:
            raise ValueError(
                "attention: history (shared-prefix suffix prefill) supports "
                "global causal layers only"
            )
        o = _attend_with_history(q, k, v, history, cfg,
                                 flash=attn_kernel != "dense")
    elif attn_kernel in ("flash", "flash_tight"):
        o = _flash_attend(q, k, v, cfg, causal=cfg.causal, window=window)
    else:
        o = _softmax_attend(
            q, k, v, _make_mask(S, S, cfg.causal, window, x.device), cfg
        )
    out = linear(p["wo"], o.reshape(B, S, -1), **_linear_kw(cfg, masks, "wo", pack))
    if reduce and parallel(p, cfg):
        out = tp.reduce_from_model(out)
    return out, (k, v)


def _attend_with_history(q, k, v, history, cfg, *, flash: bool):
    """Suffix-only prefill attention: paged prefix + causal self block.

    q/k/v: (B, S, H|KV, hd) for the suffix positions ctx..ctx+S-1.  Each
    query attends [prefix keys gathered through the table, live iff kpos <
    ctx] ++ [suffix keys, j <= i]: the keys a full prefill's rows ctx.. see.
    dense: one masked softmax over the concatenation.  flash: K12
    (``flash_attention_paged``) over the prefix pages and K9 (causal, with
    its lse) over the suffix, merged by logsumexp in f32; K12's rows with
    no live key have lse = -1e30, so their weight underflows to exactly 0.
    """
    B, S, H, hd = q.shape
    pool, table, ctx = history["pool"], history["table"], history["ctx"]
    if not flash:
        view = gather_kv_pool(pool, table)
        Hlen = view["k"].shape[1]
        hist_m = torch.arange(Hlen, device=q.device)[None, :] < ctx[:, None]
        self_m = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        mask = torch.cat([hist_m[:, None, :].expand(B, S, Hlen),
                          self_m[None].expand(B, S, S)], dim=-1)
        return _softmax_attend(
            q, torch.cat([view["k"].to(k.dtype), k], dim=1),
            torch.cat([view["v"].to(v.dtype), v], dim=1),
            mask[:, None, None], cfg,
        )
    softcap = float(cfg.logit_softcap or 0.0)
    KV = k.shape[2]
    o_hist, l_hist = flash_attention_paged(
        q.transpose(1, 2).contiguous(), pool["k"], pool["v"], table, ctx,
        softcap=softcap,
    )  # (B, H, S, hd), (B, H, S)
    fold = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, hd)
    o_self, l_self = flash_attention(
        fold(q), fold(k), fold(v), causal=True, window=0, return_lse=True,
        softcap=softcap, kv_groups=H // KV,
    )
    o_self = o_self.reshape(B, H, S, hd)
    l_self = l_self.reshape(B, H, S)  # finite: every row attends itself
    m = torch.maximum(l_hist, l_self)
    w1 = torch.exp(l_hist - m)[..., None]
    w2 = torch.exp(l_self - m)[..., None]
    o = (w1 * o_hist.float() + w2 * o_self.float()) / (w1 + w2)
    return o.transpose(1, 2).to(q.dtype)


def init_kv_cache(cfg, kind: str, batch: int, max_len: int, dtype, device):
    """Cache shapes: local layers keep only a ring buffer of cfg.window."""
    size = min(cfg.window, max_len) if (kind == "local" and cfg.window) else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_pool(cfg, n_blocks: int, page_size: int, dtype, device):
    """One layer's paged cache: ``n_blocks`` pages of (page_size, KV, hd),
    shared by every slot through its block table; page ids are group-wide
    (``serving/block_pool.py``)."""
    shape = (n_blocks, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gather_kv_pool(pool, table):
    """Slot-major contiguous view {"k"/"v": (B, T * bs, KV, hd)} of the
    pages ``table`` (B, T) names.  The sentinel N reads page N - 1 (the
    reference's clip): junk lanes every consumer masks, like the stale
    positions of a recycled contiguous slot."""
    B, T = table.shape
    N, bs = pool["k"].shape[:2]
    tab = table.long().clamp(0, N - 1)
    return {n: leaf[tab].reshape(B, T * bs, *leaf.shape[2:])
            for n, leaf in pool.items()}


def _scatter_drop(leaf, target, vals, keep):
    """``leaf[target[e]] = vals[e]`` where ``keep[e]``, in place: the
    reference's scatter with ``mode='drop'``.  target (E,) indexes leaf's
    first dim and must lie in range for kept entries; the others are
    clamped and write what their slot will hold anyway (the value of the
    first kept entry of the same target, else the slot's own content), so
    every duplicate index writes the same bits and no sync is needed."""
    tgt = target.long().clamp(0, leaf.shape[0] - 1)
    match = (tgt[:, None] == tgt[None, :]) & keep[None, :]  # (E, E)
    first = match.long().argmax(1)
    has = match.any(1).view(-1, *([1] * (vals.dim() - 1)))
    leaf[tgt] = torch.where(has, vals[first].to(leaf.dtype), leaf[tgt])


def fill_kv_pool(pool, row, table):
    """Scatter one prefilled contiguous cache row {"k"/"v": (1, size, KV,
    hd)} into the pool through ``table`` (T,) int32 (T * page_size ==
    size), in place.  Sentinel entries are dropped, so a partly allocated
    table never clobbers a page."""
    N, bs = pool["k"].shape[:2]
    T = table.shape[0]
    keep = table < N
    for n, leaf in pool.items():
        _scatter_drop(leaf, table, row[n][0].reshape(T, bs, *leaf.shape[2:]), keep)
    return pool


def fill_kv_pool_suffix(pool, k, v, table, start, n_valid):
    """Scatter suffix K/V (1, S, KV, hd), already roped, at positions
    start..start+S-1 through ``table`` (T,): position p lands at
    (table[p // bs], p % bs).  Positions at or past ``n_valid`` (bucket
    padding) and sentinel pages are dropped.  Global (linear) caches only,
    in place."""
    N, bs = pool["k"].shape[:2]
    S = k.shape[1]
    ar = torch.arange(S, device=k.device)
    posv = start + ar
    pg = table[torch.clamp(torch.div(posv, bs, rounding_mode="floor"),
                           max=table.shape[0] - 1)].long()
    keep = (ar < n_valid) & (pg < N)
    flat = pg.clamp(0, N - 1) * bs + posv % bs
    for n, t in (("k", k), ("v", v)):
        leaf = pool[n].view(N * bs, *pool[n].shape[2:])
        _scatter_drop(leaf, flat, t[0], keep)
    return pool


def fill_kv_cache(cache, k, v, start: int = 0, n_valid=None):
    """Prefill: write roped k/v (B, S, KV, hd) into the cache, in place.

    Windowed (ring) caches store position p at slot p % size, as
    ``attn_decode`` addresses them.  ``n_valid`` (start 0 only): positions
    >= n_valid are prompt padding and are never written; each slot takes
    the LATEST valid position that owns it, so a wrapped ring holds exactly
    the last ``size`` true positions (a padded write would clobber one).
    """
    S = k.shape[1]
    size = cache["k"].shape[1]
    if n_valid is not None:
        if start != 0:
            raise ValueError("fill_kv_cache: n_valid assumes a prefill at start=0")
        W = min(S, size)
        s_idx = torch.arange(W, device=k.device)
        lap = torch.clamp(torch.div(n_valid - 1 - s_idx, size, rounding_mode="floor"), min=0)
        src = s_idx + size * lap  # latest valid position landing on slot s
        has = (s_idx < n_valid)[None, :, None, None]
        for name, t in (("k", k), ("v", v)):
            c = cache[name]
            c[:, :W] = torch.where(has, t[:, src].to(c.dtype), c[:, :W])
        return cache
    if S >= size:  # keep the last `size` positions, ring-aligned
        shift = (start + S - size) % size
        k = torch.roll(k[:, S - size:], shift, dims=1)
        v = torch.roll(v[:, S - size:], shift, dims=1)
        start, S = 0, size
    cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
    return cache


def attn_decode(p, x_t, cache, pos, cfg, *, kind: str = "global", masks=None,
                pack=None, active=None, table=None):
    """One decode step.  x_t: (B, 1, d); pos: int, or a (B,) tensor giving
    every slot its own position (the serving engine).  ``active`` (B,) bool
    (needs per-slot pos): inactive rows leave the cache as it was; their
    output is garbage the engine never reads.  Returns (out, cache) with
    the cache updated in place.

    ``table`` (B, T) int32 switches to paged addressing (needs per-slot
    pos): ``cache`` is a pool (``init_kv_pool``), position p writes at
    (table[b, slot // bs], slot % bs) with the contiguous path's ring or
    linear ``slot``, and attention runs on the gathered view
    (``gather_kv_pool``) of length T * bs, whose bytes are the contiguous
    cache's: paged decode is token-identical to contiguous decode.
    Inactive rows' writes are dropped.
    """
    B = x_t.shape[0]
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if active is not None and not per_slot:
        raise ValueError("attn_decode: active-slot mask requires pos: (B,)")
    q, k, v = _qkv(p, x_t, cfg, masks, pack)
    posv = pos[:, None] if per_slot else torch.full((1,), int(pos), device=x_t.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)

    ring = kind == "local" and cfg.window
    if table is not None:
        if not per_slot:
            raise ValueError("attn_decode: paged cache requires pos: (B,)")
        N, bs = cache["k"].shape[:2]
        size = table.shape[1] * bs
        slots = torch.remainder(pos, size) if ring else pos
        rows = torch.arange(B, device=x_t.device)
        pg = table[rows, torch.clamp(torch.div(slots, bs, rounding_mode="floor"),
                                     0, table.shape[1] - 1)].long()
        keep = pg < N
        if active is not None:  # dead slots' writes drop
            keep = keep & active
        flat = pg.clamp(0, N - 1) * bs + slots % bs
        for name, t in (("k", k), ("v", v)):
            leaf = cache[name].view(N * bs, *cache[name].shape[2:])
            _scatter_drop(leaf, flat, t[:, 0], keep)
        view = gather_kv_pool(cache, table)
        valid = torch.arange(size, device=x_t.device)[None, :] <= pos[:, None]
        o = _softmax_attend(q, view["k"], view["v"],
                            valid[:, None, None, None, :], cfg)
        out = linear(p["wo"], o.reshape(B, 1, -1), **_linear_kw(cfg, masks, "wo", pack))
        return out, cache
    size = cache["k"].shape[1]
    arange = torch.arange(size, device=x_t.device)
    if per_slot:
        slots = torch.remainder(pos, size) if ring else pos
        if active is not None:  # a parked slot's stale pos may be any value
            slots = torch.where(active, slots, 0)
        rows = torch.arange(B, device=x_t.device)
        for name, t in (("k", k), ("v", v)):
            new = t[:, 0].to(cache[name].dtype)
            if active is not None:  # inactive rows write back what they hold
                new = torch.where(active[:, None, None], new, cache[name][rows, slots])
            cache[name][rows, slots] = new
        valid = arange[None, :] <= pos[:, None]  # (B, size)
    else:
        slot = int(pos) % size if ring else int(pos)
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        valid = (arange <= int(pos))[None, :]
    o = _softmax_attend(q, cache["k"], cache["v"],
                        valid[:, None, None, None, :], cfg)
    out = linear(p["wo"], o.reshape(B, 1, -1), **_linear_kw(cfg, masks, "wo", pack))
    return out, cache
