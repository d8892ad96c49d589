"""Feed-forward block (SwiGLU) of the port: ``models/mlp.py`` of the JAX
package, with every projection through ``layers.linear``."""
from __future__ import annotations

import torch.nn.functional as F

from .layers import linear, linear_init

__all__ = ["mlp_init", "mlp"]


def mlp_init(gen, d: int, d_ff: int, kind: str = "swiglu", *,
             sparse: bool = True):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    return {
        "wi": linear_init(gen, d, d_ff, sparse=sparse),
        "wg": linear_init(gen, d, d_ff, sparse=sparse),
        "wo": linear_init(gen, d_ff, d, sparse=sparse),
    }


def mlp(p, x, kind: str = "swiglu", *, masks=None, kernel=None,
        block=(128, 128, 128), pack=None, compute_dtype=None):
    """SwiGLU: wo(silu(wg x) * wi x).  ``pack`` mirrors ``masks`` and sizes
    the block-sparse kernel's loops to the true active-block count."""
    if kind != "swiglu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")

    def kw(name):
        return dict(
            kernel=kernel, block=block,
            mask=None if masks is None else masks[name]["w"],
            pack=None if pack is None else pack[name]["w"],
        )

    h = linear(p["wi"], x, compute_dtype, **kw("wi"))
    h = F.silu(linear(p["wg"], x, compute_dtype, **kw("wg"))) * h
    return linear(p["wo"], h, compute_dtype, **kw("wo"))
