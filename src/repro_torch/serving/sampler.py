"""Per-slot token sampling of the port: greedy, temperature and top-k, on
per-request threefry streams that give the reference's bits.

Port of the JAX package's ``serving/sampler.py``.  A request's stream is
``fold_in(PRNGKey(seed), n_generated)``, so its tokens do not depend on the
slot it landed in, the engine's capacity or the other requests of a step.
The reference draws with ``jax.random`` (threefry-2x32, partitionable
counters, the default of the JAX it runs on); the port computes the same
function in torch integer arithmetic, on the logits' device, so the same
seed and logits sample the same token:

  * ``PRNGKey(seed)``   -> (0, seed mod 2**32) without 64-bit JAX types;
  * ``fold_in(k, d)``   -> threefry2x32(k, (0, d));
  * ``categorical``     -> argmax(logits + gumbel), gumbel = -log(-log(u)),
    u = max(tiny, (bits >> 9 | 0x3F800000 as f32) - 1) with
    bits[i] = x0 ^ x1 of threefry2x32(k, (0, i)) (the "low" gumbel mode).

uint32 values live in int64 tensors, masked to 32 bits after every add and
shift.  ``temperature <= 0`` is greedy (the argmax of the raw logits) and
``top_k <= 0`` keeps the whole distribution, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["request_key", "step_keys", "sample_tokens", "threefry2x32",
           "random_bits"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counters (x0, x1) under key (k0, k1):
    int64 tensors holding uint32 values, broadcast together.  Returns the
    two output words, as the reference's ``threefry2x32_p``."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def request_key(seed: int) -> np.ndarray:
    """Host-side (2,) uint32 base key of one request: the reference's
    ``jax.random.PRNGKey(seed)`` (32-bit JAX types: the high word is 0 and
    the seed wraps modulo 2**32)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def step_keys(base_keys, gen_idx):
    """(B, 2) base keys + (B,) generated-token counters, integer tensors on
    one device -> (B, 2) per-step keys (int64 holding uint32): ``fold_in``
    per row."""
    k = base_keys.long() & _M32
    y0, y1 = threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(k[:, 0]),
                          gen_idx.long() & _M32)
    return torch.stack([y0, y1], dim=1)


def random_bits(keys, n: int):
    """(B, 2) keys -> (B, n) uint32 bits (int64) of ``random_bits(key, 32,
    (n,))`` per row."""
    cnt = torch.arange(n, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(cnt), cnt)
    return y0 ^ y1


def _gumbel(keys, n: int):
    """(B, n) f32 standard gumbel noise of ``jax.random.gumbel`` per row."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    # uniform(minval=tiny, maxval=1): u * (1 - tiny) + tiny, where 1 - tiny
    # rounds to 1 in f32, then max(tiny, .)
    u = torch.clamp_min(u + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, keys, temperature, top_k):
    """One token per row.  logits (B, V) f32; keys (B, 2) per-row step keys
    (``step_keys``); temperature (B,) f32 (<= 0 greedy); top_k (B,) int
    (<= 0 no filter) -> (B,) int64, all on the logits' device.  Ties at the
    k-th largest scaled logit are all kept, as in the reference."""
    V = logits.shape[-1]
    greedy_tok = logits.argmax(-1)
    scaled = logits / torch.clamp_min(temperature.float(), 1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, torch.clamp(top_k.long() - 1, 0, V - 1)[:, None])
    keep = (top_k[:, None] <= 0) | (scaled >= kth)
    filtered = torch.where(keep, scaled, float("-inf"))
    sampled = (filtered + _gumbel(keys, V)).argmax(-1)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
