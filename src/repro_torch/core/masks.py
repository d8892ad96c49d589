"""Mask trees: random block-aligned sparsification, application, paths.

Port of the JAX package's ``core/masks.py``.  Params are nested dicts and
lists of tensors; a mask tree mirrors them, with a bool tensor for each
sparsifiable weight and ``None`` for dense parameters.  Leaves are named by
``path_name`` strings (``layers/0/attn/wq/w``), walking dict keys in sorted
order as ``jax.tree_util`` does, so names and leaf order agree between the
two packages.  Random draws come from an explicit ``torch.Generator``; they
do not reproduce ``jax.random`` streams, so parity tests bridge the JAX
package's masks instead of redrawing them.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

__all__ = [
    "path_name",
    "tree_paths",
    "tree_map",
    "random_mask",
    "random_block_mask",
    "block_mask_of",
    "init_masks",
    "apply_masks",
    "mask_stats",
]


def path_name(path) -> str:
    """Key path (a sequence of dict keys and list indices) -> 'a/b/c'."""
    return "/".join(str(k) for k in path)


def _walk(tree, prefix: tuple) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_paths(tree) -> dict[str, Any]:
    """Flatten a tree into {path_string: leaf}; ``None`` leaves vanish."""
    return {path_name(p): v for p, v in _walk(tree, ()) if v is not None}


def tree_map(fn: Callable, tree, *rest, is_leaf=None, _prefix: tuple = ()):
    """Structure-preserving map; ``fn(name, leaf, *rest_leaves)``.

    ``rest`` trees mirror ``tree`` (``None`` leaves included).  ``is_leaf``
    marks containers to hand to ``fn`` whole (as ``jax.tree_util``'s).
    """
    if is_leaf is not None and is_leaf(tree):
        return fn(path_name(_prefix), tree, *rest)
    if isinstance(tree, dict):
        return {
            k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf,
                        _prefix=_prefix + (k,))
            for k in tree
        }
    if isinstance(tree, (list, tuple)):
        return [
            tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf,
                     _prefix=_prefix + (i,))
            for i, v in enumerate(tree)
        ]
    return fn(path_name(_prefix), tree, *rest)


def random_mask(gen: torch.Generator, shape, sparsity: float) -> torch.Tensor:
    """Random bool mask with EXACTLY round((1-sparsity)*N) nonzeros."""
    n = int(np.prod(shape))
    k = int(round((1.0 - sparsity) * n))
    scores = torch.rand(n, generator=gen, device=gen.device)
    mask = torch.zeros(n, dtype=torch.bool, device=gen.device)
    mask[torch.topk(scores, k).indices] = True
    return mask.reshape(shape)


def random_block_mask(gen: torch.Generator, shape, sparsity: float,
                      block_shape) -> torch.Tensor:
    """Block-aligned random mask: EXACT count of active (bk, bn) blocks.

    Blocks tile the trailing two dims.  Falls back to an elementwise mask
    when the block does not tile the shape; such layers must not go to the
    block-sparse kernel (``launch/serve.py::init_serving_state`` rejects
    them).
    """
    bk, bn = block_shape
    if len(shape) < 2 or shape[-2] % bk or shape[-1] % bn:
        return random_mask(gen, shape, sparsity)
    blk = random_mask(
        gen, (*shape[:-2], shape[-2] // bk, shape[-1] // bn), sparsity
    )
    return blk.repeat_interleave(bk, dim=-2).repeat_interleave(bn, dim=-1)


def block_mask_of(mask, block_shape):
    """Elementwise (..., K, N) mask -> (..., K/bk, N/bn) block-activity mask.

    A block is active iff ANY of its elements is.  Takes and returns numpy
    arrays or torch tensors alike.
    """
    bk, bn = block_shape
    *lead, K, N = mask.shape
    if K % bk or N % bn:
        raise ValueError(f"block {block_shape} does not tile mask {tuple(mask.shape)}")
    return mask.reshape(*lead, K // bk, bk, N // bn, bn).any(-1).any(-2)


def init_masks(gen: torch.Generator, params, sparsities: Mapping[str, float],
               block_shape=None):
    """Mask tree mirroring ``params``: bool tensors for the paths in
    ``sparsities``, ``None`` elsewhere.  ``block_shape`` draws block-aligned
    masks so the topology runs on the block-sparse kernel from the start."""

    def draw(name, leaf):
        s = sparsities.get(name)
        if s is None:
            return None
        if block_shape is not None:
            return random_block_mask(gen, tuple(leaf.shape), s, block_shape)
        return random_mask(gen, tuple(leaf.shape), s)

    return tree_map(draw, params)


def apply_masks(params, masks):
    """Effective weights w * m (dense leaves pass through)."""
    return tree_map(
        lambda _, w, m: w if m is None else w * m.to(w.dtype), params, masks
    )


def mask_stats(masks) -> dict[str, Any]:
    """Per-layer and overall sparsity bookkeeping (host-side; one device
    sync per layer)."""
    out: dict[str, Any] = {"layers": {}}
    total = active = 0
    for name, m in tree_paths(masks).items():
        size, a = int(m.numel()), int(m.sum())
        out["layers"][name] = {"size": size, "nnz": a, "sparsity": 1.0 - a / size}
        total += size
        active += a
    out["total"] = total
    out["nnz"] = active
    out["sparsity"] = 1.0 - active / total if total else 0.0
    return out
