"""Optimizers: own copy of the JAX package's ``optim/optimizers.py``.

SGD with momentum (and Nesterov) and Adam with bias correction, both
sparse-aware as in the reference: the optimizer only ever sees MASKED
gradients, and ``reset_new_connections`` zeroes per-connection state for
connections a RigL update just grew.  Trees are the port's nested dicts and
lists of tensors (``None`` leaves pass through).  ``apply_opt`` updates in
place (see its docstring); the reset functions return new trees.

``apply_opt_fused`` is the optimizer half of the fused SGD epilogue: the
masked wgrad kernel K19 already emits the new momentum as the weight
gradient (``kernels/masked_matmul.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.masks import tree_map

__all__ = [
    "OptConfig",
    "init_opt",
    "apply_opt",
    "apply_opt_fused",
    "reset_connections",
    "reset_new_connections",
    "global_norm",
]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "sgd"  # sgd | adam
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 0.0  # global-norm clip (paper char-LM uses 10.0)
    state_dtype: str = "float32"  # bfloat16 halves momentum HBM (grok-1)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def global_norm(tree, *, sharded=None, group=None) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32, on the leaves' device
    (a 0-d tensor: no host sync).  A leaf larger than ``CHUNK`` elements
    sums its row chunks' squares in order (its squares never exist at
    once).

    Under tensor parallelism (``group``, the model ranks' process group,
    and ``sharded``, a tree of bools mirroring ``tree``: which leaves each
    rank holds a slice of) the sharded leaves' squares are summed over the
    group and a replicated leaf counts once, so the norm is the whole
    model's, the same on every rank."""
    sq = lambda g: sum(torch.sum(torch.square(g[r].float())) for r in _row_chunks(g))
    if group is None:
        return torch.sqrt(sum(sq(g) for g in _leaves(tree)))
    parts = {True: [], False: []}
    tree_map(lambda _, g, s: None if g is None else parts[bool(s)].append(sq(g)),
             tree, sharded)
    dev = next(_leaves(tree)).device
    local = sum(parts[True], torch.zeros((), dtype=torch.float32, device=dev))
    dist.all_reduce(local, group=group)
    return torch.sqrt(sum(parts[False], local))


def init_opt(cfg: OptConfig, params, *, device=None):
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    z = lambda: tree_map(lambda _, p: torch.zeros(p.shape, dtype=dt, device=p.device),
                         params)
    if cfg.kind == "sgd":
        return {"momentum": z()}
    if cfg.kind == "adam":
        dev = device or next(_leaves(params)).device
        return {"m": z(), "v": z(), "count": torch.zeros((), dtype=torch.int32, device=dev)}
    raise ValueError(cfg.kind)


def apply_opt(cfg: OptConfig, grads, opt_state, params, lr, *, ok=None,
              gnorm=None):
    """Update ``params`` and ``opt_state`` IN PLACE from the MASKED grads
    and return them.  ``lr`` is a float or a 0-d float32 tensor.

    ``ok`` (0-d bool tensor, optional) is the non-finite guard: where it is
    False every leaf keeps its old value, bit for bit, decided on the
    device.  ``gnorm``: the grads' global norm, when the caller has it (the
    grad_clip scale needs it).  In place, unlike the reference's pure
    function: a full-width model has no room for a second copy of its
    params and moments; a large leaf is updated in row chunks
    (``_row_chunks``) for the same reason.

    Adam from a bf16 state (``state_dtype='bfloat16'``): the reference's
    update returns f32 moments (``b1 * m`` in bf16 plus the f32 gradient
    term promotes), which bf16 storage cannot take in place.  So the first
    update replaces every bf16 ``m``/``v`` leaf of ``opt_state`` with an f32
    tensor (the dict's trees are swapped, the old tensors dropped); a
    skipped step (``ok`` False) keeps the old values promoted, as
    ``jnp.where`` does.  SGD's momentum keeps its dtype (rounded every
    step, as the reference's ``m_new.astype(m.dtype)``).
    """
    scale = None
    if cfg.grad_clip:
        gnorm = global_norm(grads) if gnorm is None else gnorm
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    put = lambda dst, new: _put(dst, new, ok)

    def clipped(g):
        return g if scale is None else g * scale

    if cfg.kind == "sgd":
        def upd(_, g, m, p):
            for r in _row_chunks(p):
                p_new, m_new = _sgd(cfg, clipped(g[r]), m[r], p[r], lr)
                put(p[r], p_new)
                put(m[r], m_new)

        tree_map(upd, grads, opt_state["momentum"], params)
        return params, opt_state
    if cfg.kind == "adam":
        count = opt_state["count"] + 1
        c = count.float()
        b1c = 1.0 - cfg.b1 ** c
        b2c = 1.0 - cfg.b2 ** c

        def upd(_, g, m, v, p):
            # the update reads the old leaves (a bf16 one in its own dtype,
            # as the reference's arithmetic) and writes the f32 ones
            m32, v32 = _f32(m), _f32(v)
            for r in _row_chunks(p):
                p_new, m_new, v_new = _adam(cfg, clipped(g[r]), m[r], v[r], p[r], lr, b1c,
                                            b2c)
                put(p[r], p_new)
                put(m32[r], m_new)
                put(v32[r], v_new)
            return m32, v32

        out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
        for i, k in enumerate(("m", "v")):
            opt_state[k] = tree_map(lambda _, t: t[i], out,
                                    is_leaf=lambda x: isinstance(x, tuple))
        put(opt_state["count"], count)
        return params, opt_state
    raise ValueError(cfg.kind)


def _f32(t):
    """``t`` itself when f32, else an f32 copy (the old values promoted)."""
    return t if t.dtype == torch.float32 else t.float()


def _put(dst, new, ok):
    dst.copy_(new if ok is None else torch.where(ok, new, dst))


CHUNK = 1 << 27  # elements of a leaf an update step takes at a time


def _row_chunks(p):
    """Slices of ``p``'s leading dim, each of at most ``CHUNK`` elements
    (one slice for a smaller leaf): the update's elementwise temporaries
    then take a few chunks' bytes, not several copies of the largest leaf
    (a tied 256000 x 12288 f32 table is 12.6 GB).  The same bits."""
    if p.dim() == 0 or p.numel() <= CHUNK:
        return (...,)
    rows = max(1, CHUNK // (p.numel() // p.shape[0]))
    return tuple(slice(r, r + rows) for r in range(0, p.shape[0], rows))


def _sgd(cfg, g, m, p, lr):
    g = g.float() + cfg.weight_decay * p.float()
    m_new = cfg.momentum * m + g
    step = (g + cfg.momentum * m_new) if cfg.nesterov else m_new
    return (p - lr * step).to(p.dtype), m_new.to(m.dtype)


def _adam(cfg, g, m, v, p, lr, b1c, b2c):
    g = g.float()
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
    step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
    step = step + cfg.weight_decay * p.float()
    return (p - lr * step).to(p.dtype), m_new, v_new


def apply_opt_fused(cfg: OptConfig, grads, opt_state, params, lr, fused_flags,
                    *, ok=None):
    """SGD update of the fused-epilogue path, IN PLACE (the reference's
    ``apply_opt_fused``).  ``fused_flags`` mirrors ``grads`` with Python
    bools.  A flagged leaf arrives as the new momentum m_new = mu*mom + dw
    + wd*w (the fused kernel's weight cotangent, re-masked by the train
    step), so its update is ``p -= lr*g; momentum := g``; other leaves
    (embeddings, norms, the head) get the plain SGD-momentum update with
    ``cfg.weight_decay``, as ``apply_opt``.  ``ok``: the non-finite guard,
    as in ``apply_opt``.  Plain SGD only (no Nesterov, no clipping)."""
    if cfg.kind != "sgd" or cfg.nesterov or cfg.grad_clip:
        raise ValueError("apply_opt_fused: plain SGD only (no nesterov, no grad_clip)")

    def upd(_, g, m, p, fused):
        for r in _row_chunks(p):
            g32 = g[r].float()
            if fused:
                m_new = g32
            else:
                g32 = g32 + cfg.weight_decay * p[r].float()
                m_new = cfg.momentum * m[r] + g32
            p_new = (p[r] - lr * m_new).to(p.dtype)
            _put(p[r], p_new, ok)
            _put(m[r], m_new.to(m.dtype), ok)

    tree_map(upd, grads, opt_state["momentum"], params, fused_flags)
    return params, opt_state


def reset_connections(opt_state, where_masks):
    """Zero per-connection optimizer state wherever ``where_masks`` is True
    (after a RigL update for grown connections; after a Top-KAST superset
    refresh for leavers)."""

    def reset_tree(tree):
        return tree_map(
            lambda _, x, where: x if where is None or x.dim() == 0
            else torch.where(where, torch.zeros_like(x), x),
            tree, where_masks,
        )

    out = dict(opt_state)
    for k in ("momentum", "m", "v"):
        if k in out:
            out[k] = reset_tree(out[k])
    return out


def reset_new_connections(opt_state, grown_masks):
    """Zero per-connection optimizer state where a connection was just grown."""
    return reset_connections(opt_state, grown_masks)
