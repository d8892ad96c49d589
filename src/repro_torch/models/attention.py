"""GQA attention of the port: RoPE, sliding window, flash prefill, KV-cache
decode.

Port of the JAX package's ``models/attention.py`` for serving.  Prefill
attention with ``attn_kernel`` 'flash' or 'flash_tight' runs the flash
kernel (``kernels/flash_attention.py``), which walks the AttnSchedule of
the prompt length; 'dense' runs the plain masked softmax.  Decode
attention is plain PyTorch, as it is plain jnp in the reference: one query
per slot over the window-bounded cache has no dead score block to skip.

Caches are updated in place (the reference returns new arrays): the serving
engine owns one batched cache for its lifetime, and in-place writes keep a
second copy of it from existing during every step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.flash_attention import flash_attention
from .layers import P, compute_dtype, linear

__all__ = [
    "attn_init",
    "attention",
    "attn_decode",
    "fill_kv_cache",
    "init_kv_cache",
    "rope",
]

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def _fan_in(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device) / np.sqrt(shape[0])


def attn_init(gen, cfg, *, sparse: bool = True):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": {"w": P(_fan_in(gen, (d, H * hd)), sparse)},
        "wk": {"w": P(_fan_in(gen, (d, KV * hd)), sparse)},
        "wv": {"w": P(_fan_in(gen, (d, KV * hd)), sparse)},
        "wo": {"w": P(_fan_in(gen, (H * hd, d)), sparse)},
    }


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


def _qkv(p, x, cfg, masks=None, pack=None):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = compute_dtype(cfg)
    q = linear(p["wq"], x, dt, **_linear_kw(cfg, masks, "wq", pack)).reshape(B, S, H, hd)
    k = linear(p["wk"], x, dt, **_linear_kw(cfg, masks, "wk", pack)).reshape(B, S, KV, hd)
    v = linear(p["wv"], x, dt, **_linear_kw(cfg, masks, "wv", pack)).reshape(B, S, KV, hd)
    return q, k, v


def _scores(q, k, cfg):
    """q: (B, Sq, KV, G, hd); k: (B, Sk, KV, hd) -> f32 (B, KV, G, Sq, Sk).
    q is scaled in its own dtype first, as in the reference."""
    q = q * float(1.0 / np.sqrt(cfg.head_dim))
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        s = c * torch.tanh(s / c)
    return s


def _softmax_attend(q, k, v, valid, cfg):
    """Masked softmax attention; valid broadcasts against (B, KV, G, Sq, Sk).
    The weights are cast to v.dtype before the value product."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    s = _scores(q.reshape(B, Sq, KV, H // KV, hd), k, cfg)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
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
              pack=None):
    """Full-sequence attention (prefill).  Returns (out, (k, v)).

    kind: 'global' or 'local' (sliding window ``cfg.window``).  ``masks`` /
    ``pack`` route the projections through ``layers.linear``.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, masks, pack)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else 0
    attn_kernel = cfg.sparse.attn_kernel
    if attn_kernel in ("flash", "flash_tight"):
        o = _flash_attend(q, k, v, cfg, causal=cfg.causal, window=window)
    elif attn_kernel == "dense":
        o = _softmax_attend(
            q, k, v, _make_mask(S, S, cfg.causal, window, x.device), cfg
        )
    else:
        raise ValueError(f"unknown sparse.attn_kernel {attn_kernel!r}")
    out = linear(p["wo"], o.reshape(B, S, -1), compute_dtype(cfg),
                 **_linear_kw(cfg, masks, "wo", pack))
    return out, (k, v)


def init_kv_cache(cfg, kind: str, batch: int, max_len: int, dtype, device):
    """Cache shapes: local layers keep only a ring buffer of cfg.window."""
    size = min(cfg.window, max_len) if (kind == "local" and cfg.window) else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
                pack=None, active=None):
    """One decode step.  x_t: (B, 1, d); pos: int, or a (B,) tensor giving
    every slot its own position (the serving engine).  ``active`` (B,) bool
    (needs per-slot pos): inactive rows leave the cache as it was; their
    output is garbage the engine never reads.  Returns (out, cache) with
    the cache updated in place.
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
    out = linear(p["wo"], o.reshape(B, 1, -1), compute_dtype(cfg),
                 **_linear_kw(cfg, masks, "wo", pack))
    return out, cache
