"""Deterministic synthetic data streams: the port of the JAX package's
``data/synthetic.py`` for token models (``lm_batch``, ``affine_lm_batch``).

Every batch is a pure function of (seed, step, host_id), so any host can
recompute any shard.  The draws come from a ``torch.Generator`` seeded
from that triple, NOT from the reference's threefry streams: the same
arguments give other tokens than the JAX package.  Parity tests therefore
hand the reference's batches to both packages; this module feeds the
port's own runs.  The vlm and audio frontends are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["lm_batch", "affine_lm_batch", "batch_for"]

_MASK64 = (1 << 63) - 1


def _gen(seed: int, step: int, host_id: int, device) -> torch.Generator:
    # splitmix-style mixing of the triple into one 63-bit seed
    h = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
         + host_id * 0x94D049BB133111EB) & _MASK64
    return torch.Generator(device=device).manual_seed(h)


def _tokens(cfg, gen, batch: int, seq: int, device):
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device, dtype=torch.int64)


def lm_batch(cfg, step: int, batch: int, seq: int, *, seed: int = 17,
             host_id: int = 0, device="cpu"):
    """Random tokens + random targets (shape/throughput work only)."""
    gen = _gen(seed, step, host_id, device)
    return {"tokens": _tokens(cfg, gen, batch, seq, device),
            "targets": _tokens(cfg, gen, batch, seq, device)}


def affine_lm_batch(cfg, step: int, batch: int, seq: int, *, seed: int = 17,
                    host_id: int = 0, device="cpu"):
    """Learnable task: target = (3 * token + 7) mod V."""
    toks = _tokens(cfg, _gen(seed, step, host_id, device), batch, seq, device)
    return {"tokens": toks, "targets": (toks * 3 + 7) % cfg.vocab_size}


def batch_for(cfg, step: int, batch: int, seq: int, *, learnable: bool = False,
              **kw):
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"synthetic batches for frontend {cfg.frontend!r} are not ported yet"
        )
    fn = affine_lm_batch if learnable else lm_batch
    return fn(cfg, step, batch, seq, **kw)
