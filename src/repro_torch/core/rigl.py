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
A layer of at least ``SELECT_MIN`` units (grok-1-314b's 1.61 G-element
expert banks under elementwise masks, whose two argsorts would take some
38 GB) takes its top n by selection instead (``select_top``): the same
mask, bit for bit, in a few passes over an int32 key.

The paper's baselines share the drop and the exact counts; they differ in
the grow score:
  snfs    |dense momentum| (Dettmers & Zettlemoyer 2019), the state's
          ``dense_mom`` (superset-restricted under kernel dispatch);
  set     uniform random scores (Mocanu et al. 2018);
  topkast magnitude top-k inside the backward superset B, no
          re-initialisation, ``grown`` only outside B (Jayakumar et al.
          2020; ``_topkast_update_layer``);
and ``dsr_update`` (Mostafa & Wang 2019) drops by one global magnitude
ranking across layers and grows at random across layers.

Random draws (the superset's tie-break for zero weights, SET's and DSR's
uniform scores, Top-KAST's tie-break, ``grow_init='random'``) come from an
explicit ``torch.Generator``; they are not the reference's ``jax.random``
streams.  The uniform scores and tie-breaks are drawn by the caller (leaf
by leaf, in the masks' leaf order) and handed to the layer functions as
tensors; ``rigl_update(draws=...)`` and ``dsr_update(draw=...)`` take
them from outside, so the parity tests pass the reference's own draws in
and compare masks bit for bit.  The superset draw stays the port's own:
those tests carry the reference's supersets across and check the port's
draws by their invariants.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .masks import tree_map, tree_paths
from .schedules import UpdateSchedule

__all__ = [
    "SparseAlgo",
    "rigl_update_layer",
    "rigl_update",
    "dense_to_sparse_grad",
    "topkast_superset_layer",
    "topkast_backward_masks",
    "dsr_update",
    "draw_uniform",
]


@dataclasses.dataclass(frozen=True)
class SparseAlgo:
    """Which sparse-training method is in effect."""

    method: str = "rigl"  # rigl | set | snfs | topkast | static
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


SELECT_MIN = 1 << 27  # units from which ``_top_n`` selects instead of ranking


def _top_n(x, n):
    """``_rank_desc(x) < n`` for a 1-D f32 ``x`` and a count ``n`` (an int
    or a 0-d tensor): by ranks below ``SELECT_MIN`` elements, else by
    ``select_top``."""
    return _rank_desc(x) < n if x.numel() < SELECT_MIN else select_top(x, n)


def select_top(x, n):
    """The mask of the n largest elements of the 1-D f32 ``x``, ties to the
    lower index, NaN below everything: exactly ``_rank_desc(x) < n`` (whose
    stable sort of -x keeps equal values in index order, -0.0 equal to
    +0.0, and puts NaN last), without sorting.  The values map onto an
    order-preserving int32 key; a bisection over the key's range finds the
    n-th largest key t (32 counting passes), and a bisection over the
    index finds where the ties at t stop.  Peak memory: the key, its sign
    pass and a bool pass (~13 bytes an element); host syncs: one a pass."""
    total = x.numel()
    n = int(n)
    if n <= 0:
        return torch.zeros(total, dtype=torch.bool, device=x.device)
    if n >= total:
        return torch.ones(total, dtype=torch.bool, device=x.device)
    key = (x + 0.0).view(torch.int32)  # + 0.0: -0.0 -> +0.0
    sign = key >> 31  # -1 on a negative value, 0 else
    key ^= sign.bitwise_and_(0x7FFFFFFF)  # negatives: larger magnitude, smaller key
    del sign
    lo = -(1 << 31)
    key.masked_fill_(torch.isnan(x), lo)
    hi = (1 << 31) - 1
    while lo < hi:  # the largest t with |{key >= t}| >= n
        mid = (lo + hi + 1) // 2
        if int((key >= mid).sum()) >= n:
            lo = mid
        else:
            hi = mid - 1
    top = key > lo
    need = n - int(top.sum())
    tie = key == lo
    del key
    a, b = need, total
    while a < b:  # the shortest prefix holding ``need`` ties
        mid = (a + b) // 2
        if int(tie[:mid].sum()) >= need:
            b = mid
        else:
            a = mid + 1
    tie[a:] = False
    return top.logical_or_(tie)


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


def draw_uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform [0, 1) f32 draws of ``shape`` from ``gen``, on ``device``."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device).to(device)


def _unit_shape(shape, block_shape):
    """The shape drop/grow ranks: the weight's, or its block grid."""
    if block_shape is None:
        return tuple(shape)
    *lead, m, n = shape
    return (*lead, m // block_shape[0], n // block_shape[1])


def _exploration_score(w, m_bool, gen, block_shape=None):
    """Ranking score for backward-superset candidates (higher joins B
    first): active units rank above everything (B contains A), then
    nonzero inactive weights by |w| (+1 keeps them above the tie-break),
    then zero weights in random order."""
    mag = w.abs().float()
    if block_shape is not None:
        mag = _pool_blocks(mag, block_shape)
        m_bool = _pool_blocks(m_bool.float(), block_shape) > 0
    tie = draw_uniform(gen, mag.shape, mag.device)
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
    bwd_unit = _top_n(score.reshape(-1), k_bwd).reshape(m_unit.shape)
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
    kept = _top_n(torch.where(m, mag, neg_inf), n_keep)
    grown = _top_n(torch.where(kept, neg_inf, score), k)
    return (kept | grown).reshape(shape), grown.reshape(shape)


def rigl_update_layer(w, mask, grow_score, fraction, *, grow_init: str = "zeros",
                      gen=None, block_shape=None, lr: float = 0.0, grad=None):
    """One layer's drop/grow.  Returns (new_mask, new_w, grown_mask).

    grow_score: the grow score, same shape as w (|g| for rigl, |dense
      momentum| for snfs, uniform draws for set).
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


def _topkast_update_layer(w, mask, bwd_mask, fraction, tie, block_shape=None):
    """Top-KAST drop/grow: magnitude top-k restricted to the superset B.

    Drop the lowest-|w| actives; grow the highest-|w| candidates inside B
    (zero weights ranked below every trained one by ``tie``, uniform draws
    of the unit shape); candidates outside B score -inf and never win.
    Weights are not re-initialised: a connection entering A from B\\A
    keeps the value (and optimizer state) it earned there.  ``grown`` flags
    only never-trained entries (outside B, zero by construction).
    Returns (new_mask, w, grown)."""
    m_bool, b_bool = mask.bool(), bwd_mask.bool()
    mag = w.abs().float()
    if block_shape is not None:
        mag = _pool_blocks(mag, block_shape)
        m_u = _pool_blocks(m_bool.float(), block_shape) > 0
        b_u = _pool_blocks(b_bool.float(), block_shape) > 0
    else:
        m_u, b_u = m_bool, b_bool
    score = torch.where(mag > 0, mag + 1.0, tie.to(mag.device))
    score = torch.where(b_u, score, torch.full_like(score, -math.inf))
    new_u, _ = _drop_grow(mag, score, m_u, fraction)
    new_mask = new_u if block_shape is None else _expand_blocks(new_u, block_shape,
                                                                w.shape)
    grown = new_mask & ~m_bool & ~b_bool
    return new_mask.to(mask.dtype), w, grown


def _draw(algo: SparseAlgo, w, gen):
    """One layer's uniform draws for ``algo.method``: SET's grow scores (the
    weight's shape) or Top-KAST's tie-break (the unit shape)."""
    if gen is None:
        raise ValueError(f"method={algo.method!r} draws uniform scores: pass a generator "
                         "or draws=")
    bs = algo.block_shape if algo.method == "topkast" else None
    return draw_uniform(gen, _unit_shape(w.shape, bs), w.device)


def rigl_update(params, masks, dense_grads, t, algo: SparseAlgo, gen=None,
                lr: float = 0.0, *, dense_momentum=None, bwd_masks=None, draws=None):
    """Apply the connectivity update to every masked layer.

    Returns (new_params, new_masks, grown_masks); ``grown_masks`` tells the
    optimizer which per-connection state to reset.  ``method='static'`` is
    the identity.  Callers gate this on ``algo.schedule.is_update_step(t)``.

    ``dense_momentum``: the state's ``dense_mom``, required for 'snfs'.
    ``bwd_masks``: the Top-KAST supersets, required for 'topkast'.
    ``draws``: a tree mirroring ``masks`` of uniform draws (SET's scores of
    the weight's shape, Top-KAST's tie-breaks of the unit shape); when not
    given each layer draws its own from ``gen`` as it comes (one layer's
    draws live at a time).
    """
    if algo.method == "static":
        zeros = tree_map(lambda _, m: None if m is None
                         else torch.zeros_like(m, dtype=torch.bool), masks)
        return params, masks, zeros
    if algo.method not in ("rigl", "snfs", "set", "topkast"):
        raise ValueError(algo.method)
    fraction = algo.schedule.fraction(t)
    none = tree_map(lambda *_: None, masks)
    drawing = draws is None and algo.method in ("set", "topkast")
    draws = none if draws is None else draws
    mom = dense_momentum if dense_momentum is not None else none
    bwd = bwd_masks if bwd_masks is not None else none

    def layer(name, w, m, g, mo, b, u):
        if m is None:
            return (None, w, None)
        if drawing:
            u = _draw(algo, w, gen)
        if algo.method == "topkast":
            if b is None:
                raise ValueError(
                    "method='topkast' needs the backward-superset masks: "
                    f"bwd_masks is missing for leaf {name!r} — pass "
                    "state['bwd_masks'] (built by training/steps.py::"
                    "init_train_state, refreshed by refresh_pack) into "
                    "rigl_update(bwd_masks=...)")
            return _topkast_update_layer(w, m, b, fraction, u, algo.block_shape)
        if algo.method == "snfs":
            if mo is None:
                raise ValueError(
                    "method='snfs' grows by |dense momentum| but the state leaf "
                    f"dense_momentum is missing for {name!r} — pass "
                    "state['dense_mom'] (tracked by training/steps.py::"
                    "make_train_step) into rigl_update(dense_momentum=...)")
            score = mo
        else:
            score = u if algo.method == "set" else g
        return rigl_update_layer(w, m, score, fraction, grow_init=algo.grow_init, gen=gen,
                                 block_shape=algo.block_shape, lr=lr, grad=g)

    out = tree_map(layer, params, masks, dense_grads, mom, bwd, draws)
    pick = lambda i: tree_map(lambda _, t_: t_[i], out,
                              is_leaf=lambda x: isinstance(x, tuple))
    return pick(1), pick(0), pick(2)  # each layer: (mask, w, grown)


def dsr_update(params, masks, t, algo: SparseAlgo, gen=None, *, draw=None):
    """Dynamic Sparse Reparameterization (Mostafa & Wang 2019), the paper's
    Fig. 2-left "DSR" row: drop by one GLOBAL magnitude ranking over every
    masked layer (per-layer budgets shift), grow at random across layers;
    total nnz is kept, per-layer sparsity is free.  ``draw``: the uniform
    grow scores of the layers' concatenation (masks' leaf order), drawn
    from ``gen`` when not given.  Returns (new_params, new_masks, grown)."""
    fraction = algo.schedule.fraction(t)
    leaves = [(tree_paths(params)[n], m) for n, m in tree_paths(masks).items()]
    all_mag = torch.cat([w.abs().float().reshape(-1) for w, _ in leaves])
    all_act = torch.cat([m.reshape(-1).bool() for _, m in leaves])
    n_active = all_act.sum(dtype=torch.int32)
    k = torch.floor(fraction * n_active).to(torch.int32)
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=all_mag.device)
    kept = _rank_desc(torch.where(all_act, all_mag, neg_inf)) < (n_active - k)
    if draw is None:
        draw = draw_uniform(gen, all_mag.shape, all_mag.device)
    grown = _rank_desc(torch.where(kept, neg_inf, draw.to(all_mag.device))) < k
    new_all = kept | grown
    starts, off = {}, 0
    for n, m in tree_paths(masks).items():
        starts[n], off = off, off + m.numel()

    def split(n, w, m):
        if m is None:
            return (w, None, None)
        sl = slice(starts[n], starts[n] + w.numel())
        gr = grown[sl].reshape(w.shape)
        return (torch.where(gr, torch.zeros_like(w), w),
                new_all[sl].reshape(w.shape).to(m.dtype), gr)

    out = tree_map(split, params, masks)
    pick = lambda i: tree_map(lambda _, t_: t_[i], out,
                              is_leaf=lambda x: isinstance(x, tuple))
    return pick(0), pick(1), pick(2)


def dense_to_sparse_grad(dense_grads, masks):
    """g_sparse = g_dense * m (the optimizer only sees active connections)."""
    return tree_map(lambda _, g, m: g if m is None else g * m.to(g.dtype),
                    dense_grads, masks)
