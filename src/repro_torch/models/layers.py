"""Parameter primitives of the port: init bundles, ``linear``, ``rmsnorm``.

Port of the JAX package's ``models/layers.py`` for the transformer and
MoE families (``grouped_linear`` is the weight-bank twin of ``linear``).
Params are nested dicts of tensors; at init every leaf is a ``P`` bundle
(value, logical axes, sparsifiable) and ``split_params`` separates the
three trees.  The logical axes name each dim's role (``"embed"``,
``"heads"``, ``"mlp"``, ...), as the reference's; ``launch/sharding.py``
resolves them onto a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.ops import (
    block_sparse_linear,
    fused_block_sparse_linear,
    fused_grouped_block_sparse_linear,
    fused_grouped_masked_linear,
    fused_masked_linear,
    grouped_block_sparse_linear,
    grouped_masked_linear,
    masked_linear,
    topkast_grouped_masked_linear,
    topkast_masked_linear,
)

__all__ = [
    "P",
    "compute_dtype",
    "split_params",
    "truncated_normal_init",
    "linear_init",
    "linear",
    "grouped_linear",
    "dispatch_kw",
    "rmsnorm_init",
    "rmsnorm",
    "conv1d_causal_init",
    "conv1d_causal",
    "conv1d_causal_step",
    "assert_total_dispatch",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """The config's activation dtype (``cfg.dtype``)."""
    return _DTYPES[cfg.dtype]


@dataclasses.dataclass
class P:
    """Init-time parameter bundle (not a leaf of the final params): the
    value, its logical axes (a name or None per dim) and whether RigL
    sparsifies it."""

    value: Any
    axes: tuple
    sparse: bool = False


def split_params(tree):
    """Tree of P -> (params, axes, sparse_flags) with identical structure."""
    is_p = lambda x: isinstance(x, P)

    def walk(t, f):
        if is_p(t):
            return f(t)
        if isinstance(t, dict):
            return {k: walk(v, f) for k, v in t.items()}
        return [walk(v, f) for v in t]

    return (walk(tree, lambda p: p.value), walk(tree, lambda p: p.axes),
            walk(tree, lambda p: p.sparse))


def truncated_normal_init(gen: torch.Generator, shape, scale: float):
    """Fan-in scaled truncated normal (+-2 std), as the reference's init."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale / np.sqrt(max(fan_in, 1)))


def linear_init(gen, n_in: int, n_out: int, axes=("embed", "mlp"), *,
                sparse: bool = True):
    return {"w": P(truncated_normal_init(gen, (n_in, n_out), 1.0), axes, sparse)}


def linear(p, x, compute_dtype=None, *, mask=None, kernel=None,
           block=(128, 128, 128), pack=None):
    """y = x @ w in ``compute_dtype`` (None inherits x.dtype).

    Kernel dispatch, with a mask (the reference's ``layers.linear``):
      kernel='block_sparse'  the block-sparse kernels on the layer's
                             PackState entry ``pack`` (the weights are zero
                             outside the mask's blocks, so whole active
                             blocks run unmasked); ``pack`` None packs the
                             mask's (bk, bn) blocks on the call, as the
                             reference's ``_block_mask`` path does;
      kernel='masked'        x @ (w * m) with the mask fused into the masked
                             kernels; ``pack`` is None or a Top-KAST carrier
                             ``{"bwd_mask": B}`` (the wgrad runs on B).
    Under either kernel an entry carrying ``"mom"`` (with ``"seed"``,
    ``"mu"``, ``"wd"``, ``"sr"``: the train step's fused-epilogue entry)
    routes to the fused wrappers, whose weight cotangent is the new SGD
    momentum (K7 block-sparse, K19 masked).
    Other kernels, or ``mask=None``, compute ``x @ (w * mask)`` densely.

    A bf16 master under an f32 compute dtype (grok-1-314b's head) is not
    cast here: the kernel's Function, or ``_Upcast`` on the dense path,
    upcasts it for the product only (the reference's ``w.astype(dt)``
    values; its cotangent rounded once to bf16, as the cast's VJP)."""
    dt = compute_dtype or x.dtype
    w = _weight(p["w"], dt)
    fused = _epilogue(pack)
    if mask is not None and kernel == "block_sparse":
        if pack is None:
            pack = _pack_on_call(mask, x.shape[-1], w.shape[-1], block)
        if fused:
            return fused_block_sparse_linear(x.to(dt), w, pack["mom"], pack["seed"],
                                             pack=pack, block=block, **fused)
        return block_sparse_linear(x.to(dt), w, pack=pack, block=block)
    if mask is not None and kernel == "masked":
        xc = x.to(dt)
        if fused:
            return fused_masked_linear(xc, w, mask, pack["mom"], pack["seed"],
                                       bwd_mask=pack.get("bwd_mask"), block=block,
                                       **fused)
        if isinstance(pack, dict) and "bwd_mask" in pack:
            return topkast_masked_linear(xc, w, mask, pack["bwd_mask"], block=block)
        return masked_linear(xc, w, mask, block=block)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return _matmul(x.to(dt), w)


def grouped_linear(w, x, compute_dtype=None, *, mask=None, kernel=None,
                   block=(128, 128, 128), pack=None):
    """Grouped matmul: x (G, M, K) @ w (G, K, N) -> (G, M, N), the
    weight-BANK twin of ``linear`` (the reference's
    ``layers.grouped_linear``): the MoE experts' ``ecd,edf->ecf`` banks.

    Dispatch mirrors ``linear``, with a mask:
      kernel='block_sparse'  one launch over the bank on its grouped
                             PackState entry ``pack`` (K4 forward, K5 dgrad,
                             K6 wgrad on the entry's superset ``bidx`` when
                             it carries one); ``pack`` None packs each
                             group's blocks on the call;
      kernel='masked'        one launch with the mask fused in (K16, K17,
                             K18); ``pack`` None or the Top-KAST carrier
                             ``{"bwd_mask": B}`` (the wgrad runs on B).
    A fused-epilogue entry (``"mom"``) routes to the grouped fused wrappers,
    whose weight cotangent is the bank's new SGD momentum (K8 block-sparse,
    K20 masked).  Other kernels, or ``mask=None``, compute the batched
    product on ``w * mask`` densely.  A bf16 bank under f32 compute is
    upcast per launch, as in ``linear``.
    """
    dt = compute_dtype or x.dtype
    w = _weight(w, dt)
    fused = _epilogue(pack)
    if mask is not None and kernel in ("masked", "block_sparse"):
        xc = x.to(dt)
        if kernel == "masked":
            if fused:
                return fused_grouped_masked_linear(xc, w, mask, pack["mom"], pack["seed"],
                                                   bwd_mask=pack.get("bwd_mask"),
                                                   block=block, **fused)
            if isinstance(pack, dict) and "bwd_mask" in pack:
                return topkast_grouped_masked_linear(xc, w, mask, pack["bwd_mask"],
                                                     block=block)
            return grouped_masked_linear(xc, w, mask, block=block)
        if pack is None:
            pack = _pack_on_call(mask, x.shape[-1], w.shape[-1], block)
        if fused:
            return fused_grouped_block_sparse_linear(xc, w, pack["mom"], pack["seed"],
                                                     pack=pack, block=block, **fused)
        return grouped_block_sparse_linear(xc, w, pack=pack, block=block)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return _matmul(x.to(dt), w)


def _weight(w, dt):
    """``w`` in the compute dtype ``dt``, except a bf16 master under f32
    compute, which comes through as it is: its consumer upcasts it per
    launch (``kernels.block_sparse_matmul.upcast``, ``_Upcast``), so no f32
    copy of a bank or of the head outlives its product or is saved for the
    backward."""
    return w if (w.dtype, dt) == (torch.bfloat16, torch.float32) else w.to(dt)


def _pack_on_call(mask, K: int, N: int, block):
    """The PackState entry of ``mask``'s (bk, bn) blocks (tiles clamped to
    small dims, as the kernels clamp them), built on the call: the
    reference's ``_block_mask`` path, for a block-sparse call without a
    prebuilt entry.  A host round trip per call; no train or serve path
    takes it."""
    from ..core.pack import pack_entry

    _, bn, bk = block
    return pack_entry(mask, (min(bk, K), min(bn, N)), name="linear")


def _mm(a, b):
    return torch.bmm(a, b) if a.dim() == 3 and b.dim() == 3 else a @ b


class _Upcast(torch.autograd.Function):
    """The dense product ``x @ w`` (``torch.bmm`` for a bank) with a
    narrower ``w`` cast to x's dtype inside, for the product only: the
    cast copy is freed after it and made again in the backward, never
    saved.  w's cotangent is the f32 product rounded once to w.dtype, as
    the VJP of the reference's ``w.astype(dt)`` rounds it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm(g, w.to(g.dtype).transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            if w.dim() == 2:  # x (..., K), w (K, N): the leading dims fold
                dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
            else:
                dw = torch.bmm(x.transpose(1, 2), g)
            dw = dw.to(w.dtype)
        return dx, dw


def _matmul(x, w):
    """``x @ w`` (a bank: ``torch.bmm``), through ``_Upcast`` when w is
    narrower than x."""
    return _mm(x, w) if w.dtype == x.dtype else _Upcast.apply(x, w)


def _epilogue(pack):
    """The SGD constants ``{"mu", "wd", "sr"}`` of a fused-epilogue entry
    (one carrying ``"mom"``), else None."""
    if isinstance(pack, dict) and "mom" in pack:
        return {k: pack[k] for k in ("mu", "wd", "sr")}
    return None


def dispatch_kw(cfg, masks, name, pack=None):
    """Kernel-dispatch kwargs of one sparsifiable projection or bank
    ``name`` of a submodule (the reference's ``layers.dispatch_kw``): its
    ``{"w": ...}``-bundled mask and pack leaves and the config's kernel."""
    return dict(
        mask=None if masks is None else masks[name]["w"],
        kernel=cfg.sparse.kernel,
        block=cfg.sparse.kernel_block,
        pack=None if pack is None else pack[name]["w"],
    )


def rmsnorm_init(d: int, device, axes=("embed",)):
    return {"scale": P(torch.ones(d, dtype=torch.float32, device=device), axes)}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def conv1d_causal_init(gen: torch.Generator, d: int, width: int, axes=("conv_k", "mlp")):
    """Depthwise causal conv (the SSM's front conv); dense, as the
    reference's: w (width, d) normal / sqrt(width), b zeros."""
    w = torch.randn(width, d, generator=gen, device=gen.device) / np.sqrt(width)
    return {"w": P(w, axes), "b": P(torch.zeros(d, device=gen.device), (axes[-1],))}


def conv1d_causal(p, x, compute_dtype=None):
    """x (B, S, d) -> the depthwise causal conv along S, the reference's
    sum of the K shifted products in tap order, plus the bias."""
    dt = compute_dtype or x.dtype
    w = p["w"].to(dt)
    k, S = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    y = pad[:, 0:S] * w[0]
    for i in range(1, k):
        y = y + pad[:, i:i + S] * w[i]
    return y + p["b"].to(dt)


def conv1d_causal_step(p, state, x_t, compute_dtype=None):
    """One decode step: ``state`` (B, K-1, d) holds the last K-1 inputs,
    x_t (B, d) -> (the new state, y (B, d)).  The window ``cat([state,
    x_t])`` takes the wider of the two dtypes, as jnp's concatenate."""
    dt = compute_dtype or x_t.dtype
    w = p["w"].to(dt)
    window = torch.cat([state, x_t[:, None, :].to(torch.promote_types(
        state.dtype, x_t.dtype))], dim=1)  # (B, K, d)
    y = (window * w).sum(1) + p["b"].to(dt)
    return window[:, 1:, :], y


def assert_total_dispatch(masks, consumed=None, *, kernel=None, where: str = "?",
                          pack=None):
    """Loud guard against a silent dense fallback (the reference's
    ``layers.assert_total_dispatch``), in its two modes.

    ``consumed`` given (per submodule, the MoE layer): under kernel
    dispatch every non-None mask leaf of the submodule's mask subtree must
    sit under one of the ``consumed`` keys, the ones the caller routes
    through ``linear``/``grouped_linear``; a leftover leaf would fall back
    to ``w * m`` in device memory, so this raises.

    ``consumed`` None (the train step with backward supersets, the
    reference's ``require_bwd``): every mask leaf's ``pack`` entry must
    carry the superset view — ``bidx`` (block_sparse) or the masked
    carrier's ``bwd_mask`` — so its weight gradient runs on the superset
    (the grow scores' channel) and not on the forward topology.
    """
    if masks is None or kernel in (None, "dense"):
        return
    from ..core.masks import tree_map, tree_paths

    if consumed is not None:
        leftovers = sorted(n for n in tree_paths(masks)
                           if n.split("/")[0] not in consumed)
        if leftovers:
            raise RuntimeError(
                f"{where}: mask leaves {leftovers} have no kernel-dispatched "
                "consumer — they would silently fall back to dense w*m; route "
                "them through layers.linear/grouped_linear or keep the weights "
                "dense"
            )
        return
    view = "bwd_mask" if kernel == "masked" else "bidx"
    missing = []
    tree_map(lambda n, m, e: missing.append(n) if m is not None and not (
        isinstance(e, dict) and view in e) else None,
        masks, pack if pack is not None else tree_map(lambda *_: None, masks))
    if missing:
        raise RuntimeError(
            f"{where}: mask leaves {sorted(missing)} have no backward-superset "
            f"pack view ({view}): their weight gradient would fall back to the "
            "forward topology instead of the (k+Δ) superset; rebuild the "
            "pack with bwd_masks= (core/pack.py)"
        )
