"""RigL connectivity updates (paper §3, Algorithm 1) and the Top-KAST
backward superset: the port of the JAX package's ``core/rigl.py``.

Drop:  remove the k lowest-|w| active connections per layer,
       k = floor(f_decay(t) * n_active_l)  (exact count).
Grow:  activate the k highest-|dense gradient| connections among the
       inactive and the freshly dropped ones (official-code semantics);
       grown connections start at zero (``grow_init='zeros'``, the paper's
       default) and their optimizer state is reset by the caller.

Under kernel dispatch the "dense gradient" is the gradient restricted to
the Top-KAST backward superset B ⊇ A (``topkast_backward_masks``): the
wgrad kernel runs on B's blocks, so grow candidates outside B score zero.

Exact counts with a stable double argsort (``_rank_desc``: unique
descending ranks, ties broken by the lower flat index, the reference's own
definition), so masks after an update are bit-identical to the
reference's on the same inputs.  Block mode pools |w| and |g| (L1) over
aligned blocks, so masks stay block-aligned for the block-sparse kernels.

Random draws (the superset's tie-break for zero weights, ``grow_init=
'random'``) come from an explicit ``torch.Generator``; they are not the
reference's ``jax.random`` streams, so the parity tests carry the
reference's supersets across and check the port's own draws by their
invariants.  Methods 'set', 'snfs' and 'topkast' are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .masks import tree_map
from .schedules import UpdateSchedule

__all__ = [
    "SparseAlgo",
    "rigl_update_layer",
    "rigl_update",
    "dense_to_sparse_grad",
    "topkast_superset_layer",
    "topkast_backward_masks",
]


@dataclasses.dataclass(frozen=True)
class SparseAlgo:
    """Which sparse-training method is in effect."""

    method: str = "rigl"  # rigl | static (set | snfs | topkast: not ported yet)
    schedule: UpdateSchedule = UpdateSchedule()
    grow_init: str = "zeros"  # zeros | random | gradient
    block_shape: Optional[tuple[int, int]] = None  # block-sparse mode
    # Δ of the top-(k+Δ) backward superset, as a fraction of each layer's
    # units (elements, or blocks in block mode).
    backward_extra: float = 0.1


def _rank_desc(x):
    """Unique descending ranks (0 = largest); stable, deterministic."""
    order = torch.argsort(-x, stable=True)
    return torch.argsort(order, stable=True)


def _pool_blocks(x, block_shape):
    """Sum |x| over (bm, bn) blocks of the last two dims -> block scores."""
    bm, bn = block_shape
    *lead, m, n = x.shape
    if m % bm or n % bn:
        raise ValueError(f"block {block_shape} does not tile {tuple(x.shape)}")
    return x.reshape(*lead, m // bm, bm, n // bn, bn).sum(dim=(-3, -1))


def _expand_blocks(xb, block_shape, shape):
    bm, bn = block_shape
    return xb.repeat_interleave(bm, -2).repeat_interleave(bn, -1).reshape(shape)


def _exploration_score(w, m_bool, gen, block_shape=None):
    """Ranking score for backward-superset candidates (higher joins B
    first): active units rank above everything (B contains A), then
    nonzero inactive weights by |w| (+1 keeps them above the tie-break),
    then zero weights in random order."""
    mag = w.abs().float()
    if block_shape is not None:
        mag = _pool_blocks(mag, block_shape)
        m_bool = _pool_blocks(m_bool.float(), block_shape) > 0
    tie = torch.rand(mag.shape, generator=gen, device=gen.device).to(mag.device)
    score = torch.where(mag > 0, mag + 1.0, tie)
    return torch.where(m_bool, torch.full_like(score, math.inf), score), m_bool


def topkast_superset_layer(w, mask, extra, gen, *, block_shape=None):
    """One layer's backward mask B ⊇ A with |B| = min(total, |A| + Δ),
    Δ = ceil(extra * units)."""
    m_bool = mask.bool()
    score, m_unit = _exploration_score(w, m_bool, gen, block_shape)
    total = m_unit.numel()
    delta = int(math.ceil(float(extra) * total)) if extra else 0
    k_bwd = torch.clamp(m_unit.reshape(-1).sum() + delta, max=total)
    bwd_unit = (_rank_desc(score.reshape(-1)) < k_bwd).reshape(m_unit.shape)
    if block_shape is not None:
        bwd_unit = _expand_blocks(bwd_unit, block_shape, mask.shape)
    return bwd_unit.to(mask.dtype)


def topkast_backward_masks(params, masks, extra, gen, *, block_shape=None):
    """Backward-superset tree mirroring ``masks`` (None leaves pass
    through): per layer B = A ∪ the Δ best exploration candidates, drawn
    from ``gen`` in leaf order."""
    return tree_map(
        lambda _, w, m: None if m is None else topkast_superset_layer(
            w, m, extra, gen, block_shape=block_shape),
        params, masks,
    )


def _drop_grow(mag, score, m_bool, fraction):
    """Core exact-count drop/grow on flattened scores."""
    shape = mag.shape
    mag, score, m = mag.reshape(-1), score.reshape(-1), m_bool.reshape(-1)
    n_active = m.sum(dtype=torch.int32)
    k = torch.floor(fraction * n_active).to(torch.int32)
    n_keep = n_active - k
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=mag.device)
    kept = _rank_desc(torch.where(m, mag, neg_inf)) < n_keep
    grown = _rank_desc(torch.where(kept, neg_inf, score)) < k
    return (kept | grown).reshape(shape), grown.reshape(shape)


def rigl_update_layer(w, mask, grow_score, fraction, *, grow_init: str = "zeros",
                      gen=None, block_shape=None, lr: float = 0.0, grad=None):
    """One layer's drop/grow.  Returns (new_mask, new_w, grown_mask).

    grow_score: the dense-side score (|g| for rigl), same shape as w.
    fraction: f_decay(t) as a float32 tensor.
    """
    m_bool = mask.bool()
    if block_shape is not None:
        mag = _pool_blocks(w.abs().float(), block_shape)
        score = _pool_blocks(grow_score.abs().float(), block_shape)
        m_blk = _pool_blocks(m_bool.float(), block_shape) > 0
        new_blk, grown_blk = _drop_grow(mag, score, m_blk, fraction)
        new_mask = _expand_blocks(new_blk, block_shape, w.shape)
        grown = _expand_blocks(grown_blk, block_shape, w.shape)
    else:
        new_mask, grown = _drop_grow(w.abs().float(), grow_score.abs().float(),
                                     m_bool, fraction)
    if grow_init == "zeros":
        init_val = torch.zeros_like(w)
    elif grow_init == "random":
        if gen is None:
            raise ValueError("grow_init='random' needs a generator")
        init_val = 0.01 * torch.randn(w.shape, generator=gen, device=gen.device,
                                      dtype=w.dtype).to(w.device)
    elif grow_init == "gradient":
        if grad is None:
            raise ValueError("grow_init='gradient' needs the gradient")
        init_val = (-lr * grad).to(w.dtype)
    else:
        raise ValueError(grow_init)
    return new_mask.to(mask.dtype), torch.where(grown, init_val, w), grown


def rigl_update(params, masks, dense_grads, t, algo: SparseAlgo, gen=None,
                lr: float = 0.0):
    """Apply the connectivity update to every masked layer.

    Returns (new_params, new_masks, grown_masks); ``grown_masks`` tells the
    optimizer which per-connection state to reset.  ``method='static'`` is
    the identity.  Callers gate this on ``algo.schedule.is_update_step(t)``.
    """
    if algo.method == "static":
        zeros = tree_map(lambda _, m: None if m is None
                         else torch.zeros_like(m, dtype=torch.bool), masks)
        return params, masks, zeros
    if algo.method != "rigl":
        raise NotImplementedError(
            f"rigl_update: method {algo.method!r} is not ported yet (the port "
            "runs 'rigl' and 'static')"
        )
    fraction = algo.schedule.fraction(t)
    out = tree_map(
        lambda _, w, m, g: (None, w, None) if m is None else rigl_update_layer(
            w, m, g, fraction, grow_init=algo.grow_init, gen=gen,
            block_shape=algo.block_shape, lr=lr, grad=g),
        params, masks, dense_grads,
    )
    pick = lambda i: tree_map(lambda _, t_: t_[i], out,
                              is_leaf=lambda x: isinstance(x, tuple))
    return pick(1), pick(0), pick(2)  # rigl_update_layer: (mask, w, grown)


def dense_to_sparse_grad(dense_grads, masks):
    """g_sparse = g_dense * m (the optimizer only sees active connections)."""
    return tree_map(lambda _, g, m: g if m is None else g * m.to(g.dtype),
                    dense_grads, masks)
