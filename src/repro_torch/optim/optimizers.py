"""Optimizers: own copy of the JAX package's ``optim/optimizers.py``.

SGD with momentum (and Nesterov) and Adam with bias correction, both
sparse-aware as in the reference: the optimizer only ever sees MASKED
gradients, and ``reset_new_connections`` zeroes per-connection state for
connections a RigL update just grew.  Trees are the port's nested dicts and
lists of tensors (``None`` leaves pass through).  ``apply_opt`` updates in
place (see its docstring); the reset functions return new trees.

``apply_opt_fused`` (the fused SGD epilogue of the wgrad kernels) belongs
with the fused kernels K7/K19, which are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

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


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32, on the leaves' device
    (a 0-d tensor: no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


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
    params and moments.
    """
    scale = None
    if cfg.grad_clip:
        gnorm = global_norm(grads) if gnorm is None else gnorm
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    def put(dst, new):
        dst.copy_(new if ok is None else torch.where(ok, new, dst))

    def clipped(g):
        return g if scale is None else g * scale

    if cfg.kind == "sgd":
        def upd(_, g, m, p):
            p_new, m_new = _sgd(cfg, clipped(g), m, p, lr)
            put(p, p_new)
            put(m, m_new)

        tree_map(upd, grads, opt_state["momentum"], params)
        return params, opt_state
    if cfg.kind == "adam":
        count = opt_state["count"] + 1
        c = count.float()
        b1c = 1.0 - cfg.b1 ** c
        b2c = 1.0 - cfg.b2 ** c

        def upd(_, g, m, v, p):
            p_new, m_new, v_new = _adam(cfg, clipped(g), m, v, p, lr, b1c, b2c)
            put(p, p_new)
            put(m, m_new)
            put(v, v_new)

        tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
        put(opt_state["count"], count)
        return params, opt_state
    raise ValueError(cfg.kind)


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


def apply_opt_fused(*args, **kwargs):
    raise NotImplementedError(
        "apply_opt_fused (the SGD epilogue fused into the wgrad kernels, "
        "K7/K19) is not ported yet"
    )


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
