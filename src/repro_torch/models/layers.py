"""Parameter primitives of the port: init bundles, ``linear``, ``rmsnorm``.

Port of the JAX package's ``models/layers.py`` for the dense-family
transformer.  Params are nested dicts of tensors; at init every leaf is a
``P`` bundle (value, sparsifiable) and ``split_params`` separates the two
trees.  The reference's logical sharding axes are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.ops import block_sparse_linear

__all__ = [
    "P",
    "compute_dtype",
    "split_params",
    "truncated_normal_init",
    "linear_init",
    "linear",
    "rmsnorm_init",
    "rmsnorm",
    "assert_total_dispatch",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """The config's activation dtype (``cfg.dtype``)."""
    return _DTYPES[cfg.dtype]


@dataclasses.dataclass
class P:
    """Init-time parameter bundle (not a leaf of the final params)."""

    value: Any
    sparse: bool = False


def split_params(tree):
    """Tree of P -> (params, sparse_flags) with identical structure."""
    is_p = lambda x: isinstance(x, P)

    def walk(t, f):
        if is_p(t):
            return f(t)
        if isinstance(t, dict):
            return {k: walk(v, f) for k, v in t.items()}
        return [walk(v, f) for v in t]

    return walk(tree, lambda p: p.value), walk(tree, lambda p: p.sparse)


def truncated_normal_init(gen: torch.Generator, shape, scale: float):
    """Fan-in scaled truncated normal (+-2 std), as the reference's init."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale / np.sqrt(max(fan_in, 1)))


def linear_init(gen, n_in: int, n_out: int, *, sparse: bool = True):
    return {"w": P(truncated_normal_init(gen, (n_in, n_out), 1.0), sparse)}


def linear(p, x, compute_dtype=None, *, mask=None, kernel=None,
           block=(128, 128, 128), pack=None):
    """y = x @ w in ``compute_dtype`` (None inherits x.dtype).

    ``kernel='block_sparse'`` with a mask runs the block-sparse kernel on
    the layer's PackState entry ``pack`` (the weights are already zero
    outside the mask's blocks, so whole active blocks run unmasked).  Other
    kernels, or ``mask=None``, compute ``x @ (w * mask)`` densely.
    """
    dt = compute_dtype or x.dtype
    w = p["w"].to(dt)
    if mask is not None and kernel == "block_sparse":
        if pack is None:
            raise NotImplementedError(
                "linear: block_sparse without a PackState entry (packing the "
                "mask per call) is not ported yet; pass pack="
            )
        return block_sparse_linear(x.to(dt), w, pack=pack, block=block)
    if mask is not None and kernel == "masked":
        raise NotImplementedError(
            "linear: kernel='masked' (the fused-mask matmul kernels) is not "
            "ported yet"
        )
    if mask is not None:
        w = w * mask.to(dt)
    return x.to(dt) @ w


def rmsnorm_init(d: int, device):
    return {"scale": P(torch.ones(d, dtype=torch.float32, device=device))}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)



def assert_total_dispatch(masks, *, kernel=None, where: str = "?", pack=None):
    """Loud guard against a silent fallback of the weight gradients (the
    reference's ``layers.assert_total_dispatch`` with ``require_bwd``).

    Under kernel dispatch with backward supersets (rigl), every mask leaf's
    ``pack`` entry must carry the superset view ``bidx``, so its weight
    gradient runs on the superset's blocks (the grow scores' channel) and
    not on the forward topology.  The reference's per-submodule mode (every
    mask leaf consumed by a dispatched matmul) belongs with the model
    families that need it (MoE, xLSTM, hymba), not ported yet.
    """
    if masks is None or kernel in (None, "dense"):
        return
    from ..core.masks import tree_map

    missing = []
    tree_map(lambda n, m, e: missing.append(n) if m is not None and not (
        isinstance(e, dict) and "bidx" in e) else None,
        masks, pack if pack is not None else tree_map(lambda *_: None, masks))
    if missing:
        raise RuntimeError(
            f"{where}: mask leaves {sorted(missing)} have no backward-superset "
            "pack view (bidx): their weight gradient would fall back to the "
            "forward topology instead of the (k+Δ) superset; rebuild the "
            "pack with bwd_masks= (core/pack.py)"
        )
