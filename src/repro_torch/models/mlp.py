"""Feed-forward blocks (SwiGLU, GeGLU, GELU, ReLU) of the port:
``models/mlp.py`` of the JAX package, with every projection through
``layers.linear`` in the input's dtype (the residual stream's, as in the
reference).  Gelu is the tanh approximation, ``jax.nn.gelu``'s default;
the gated kinds hold ``wi``, ``wg`` and ``wo``, the plain ones ``wi`` and
``wo``."""
from __future__ import annotations

import torch.nn.functional as F

from . import tp
from .layers import linear, linear_init

__all__ = ["mlp_init", "mlp", "parallel"]


def _gelu(t):
    return F.gelu(t, approximate="tanh")


_GATES = {"swiglu": F.silu, "geglu": _gelu}
_ACTS = {"gelu": _gelu, "relu": F.relu}


def _check(kind: str) -> None:
    if kind not in _GATES and kind not in _ACTS:
        raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_init(gen, d: int, d_ff: int, kind: str = "swiglu", *,
             sparse: bool = True):
    _check(kind)
    p = {"wi": linear_init(gen, d, d_ff, ("embed", "mlp"), sparse=sparse)}
    if kind in _GATES:
        p["wg"] = linear_init(gen, d, d_ff, ("embed", "mlp"), sparse=sparse)
    p["wo"] = linear_init(gen, d_ff, d, ("mlp", "embed"), sparse=sparse)
    return p


def parallel(p, width) -> bool:
    """Does this rank hold a column shard of ``wi`` (tensor parallelism
    over ``model``), the FFN's whole width being ``width``?"""
    return width is not None and tp.shards(p["wi"]["w"].shape[-1], width)


def mlp(p, x, kind: str = "swiglu", *, masks=None, kernel=None,
        block=(128, 128, 128), pack=None, width=None, reduce: bool = True):
    """SwiGLU wo(silu(wg x) * wi x), GeGLU wo(gelu(wg x) * wi x), GELU
    wo(gelu(wi x)) or ReLU wo(relu(wi x)).  ``pack`` mirrors ``masks``
    and sizes the block-sparse kernel's loops to the true active-block
    count.

    ``width``: the FFN's whole width.  Where this rank holds a shard of it
    (``parallel``), ``wi``/``wg`` are column-parallel (x enters through
    ``copy_to_model``) and ``wo`` row-parallel: the output is summed over
    the model ranks, unless ``reduce`` is False (the caller sums it with
    another partial once)."""
    _check(kind)
    par = parallel(p, width)
    if par:
        x = tp.copy_to_model(x)

    def kw(name):
        return dict(
            kernel=kernel, block=block,
            mask=None if masks is None else masks[name]["w"],
            pack=None if pack is None else pack[name]["w"],
        )

    h = linear(p["wi"], x, **kw("wi"))
    if kind in _GATES:
        h = _GATES[kind](linear(p["wg"], x, **kw("wg"))) * h
    else:
        h = _ACTS[kind](h)
    out = linear(p["wo"], h, **kw("wo"))
    return tp.reduce_from_model(out) if par and reduce else out
