"""Deterministic synthetic data streams: the port of the JAX package's
``data/synthetic.py`` (``lm_batch``, ``affine_lm_batch``, ``vlm_batch``
and ``frames_batch``, chosen by ``batch_for``).

Every batch is a pure function of (seed, step, host_id), so any host can
recompute any shard.  The draws come from a ``torch.Generator`` seeded
from that triple, NOT from the reference's threefry streams: the same
arguments give other tokens than the JAX package.  Parity tests therefore
hand the reference's batches to both packages; this module feeds the
port's own runs; the shapes and the target rules are the reference's.
"""
from __future__ import annotations

import torch

__all__ = ["lm_batch", "affine_lm_batch", "vlm_batch", "frames_batch", "batch_for"]

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


def vlm_batch(cfg, step: int, batch: int, seq: int, *, seed: int = 17,
              host_id: int = 0, device="cpu"):
    """A ``patch`` config's batch: the affine task on ``seq - n_patches``
    text tokens, plus (batch, n_patches, frontend_dim) standard normal f32
    patches from the stream of ``seed + 1``, so the model's sequence is
    ``seq`` rows."""
    b = affine_lm_batch(cfg, step, batch, seq - cfg.n_patches, seed=seed,
                        host_id=host_id, device=device)
    b["patches"] = torch.randn(batch, cfg.n_patches, cfg.frontend_dim,
                               generator=_gen(seed + 1, step, host_id, device),
                               device=device)
    return b


def frames_batch(cfg, step: int, batch: int, seq: int, *, seed: int = 17,
                 host_id: int = 0, device="cpu"):
    """A ``frames`` config's batch: (batch, seq, frontend_dim) standard
    normal f32 frames, each frame's target (sum(frame**2) * 7) truncated to
    an integer, mod the vocab (a learnable class of the frame's energy)."""
    frames = torch.randn(batch, seq, cfg.frontend_dim,
                         generator=_gen(seed, step, host_id, device), device=device)
    tgts = ((frames * frames).sum(-1) * 7).int() % cfg.vocab_size
    return {"frames": frames, "targets": tgts.long()}


def batch_for(cfg, step: int, batch: int, seq: int, *, learnable: bool = False,
              **kw):
    """The config's batch: ``vlm_batch`` for a ``patch`` frontend,
    ``frames_batch`` for ``frames``, else the affine task (``learnable``)
    or random tokens."""
    if cfg.frontend == "patch":
        return vlm_batch(cfg, step, batch, seq, **kw)
    if cfg.frontend == "frames":
        return frames_batch(cfg, step, batch, seq, **kw)
    fn = affine_lm_batch if learnable else lm_batch
    return fn(cfg, step, batch, seq, **kw)
