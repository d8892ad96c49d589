"""Top-k routed Mixture-of-Experts with shared experts, of the port.

Port of the JAX package's ``models/moe.py``: sort-based "dropping"
dispatch, every shape static (a host function of the batch shape):

  1. router logits in f32 -> top_k experts and renormalised gates per token
     (``route``);
  2. flatten the (token, slot) assignments and rank them within each expert
     (stable argsort of the expert ids: rank priority to lower flat indices,
     token-major then slot);
  3. scatter the tokens into an (E * C + 1, d) buffer (capacity C; overflow
     goes to the scratch row E * C, which is sliced off);
  4. the three expert banks ``wi``/``wg``/``wo``, each (E, d, ff) or
     (E, ff, d), through ``layers.grouped_linear``: one grouped launch per
     bank under kernel dispatch (K4 on stacked per-expert packs under
     block_sparse, K16 under masked);
  5. gather back with ``keep`` and the gate-weighted combine, plus the
     shared experts as one SwiGLU MLP (``models/mlp.py``: K1 or K13).

The router stays dense (tiny, routing-critical).  A fully dead expert
outputs zeros; the pack build rejects only an all-zero bank.  Everything
stays on the device: C is a host int from the shapes, and ``keep``,
``dest`` and ``rank`` are tensors (no ``.item()``, no boolean-mask
indexing, which would synchronise the stream on every decode step).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import P, assert_total_dispatch, dispatch_kw, grouped_linear
from .mlp import mlp, mlp_init

__all__ = ["moe_init", "moe", "route", "capacity"]

# sparse leaves routed through the kernels: the grouped expert banks plus the
# shared-expert MLP (dispatched inside models/mlp.py)
_DISPATCHED = ("wi", "wg", "wo", "shared")


def moe_init(gen, cfg, *, sparse: bool = True):
    """Router (d, E), expert banks wi/wg (E, d, ff) and wo (E, ff, d) with
    fan-in scaled normal weights, and the shared MLP of width
    ff * n_shared_experts; the reference's layout, torch's draws."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    normal = lambda shape: (torch.randn(shape, generator=gen, device=gen.device)
                            / np.sqrt(shape[-2]))
    bank = lambda shape, axes: {"w": P(normal(shape), axes, sparse)}
    p = {
        "router": {"w": P(normal((d, E)), ("embed", None), False)},
        "wi": bank((E, d, ff), ("experts", "embed", "moe_mlp")),
        "wg": bank((E, d, ff), ("experts", "embed", "moe_mlp")),
        "wo": bank((E, ff, d), ("experts", "moe_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.n_shared_experts, "swiglu",
                               sparse=sparse)
    return p


def capacity(T: int, cfg) -> int:
    """Per-expert capacity C of a batch of T tokens; the floor keeps small
    decode batches from starving an expert."""
    E, K = cfg.n_experts, cfg.top_k
    return max(int(np.ceil(T * K / E * cfg.moe_capacity_factor)), min(T, 4))


def route(p, xt, cfg):
    """xt (T, d) -> (probs (T, E) f32, gates (T, K) f32, eidx (T, K)).

    Logits in f32 (the reference's ``preferred_element_type``), softmax,
    top-k by a stable descending sort: equal probabilities take the lower
    expert id first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order).  Gates are renormalised over the k picks."""
    K = cfg.top_k
    logits = xt.float() @ p["router"]["w"].to(xt.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[:, :K], order[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, eidx


def moe(p, x, cfg, *, masks=None, pack=None, active=None):
    """Routed-MoE forward.  x: (B, S, d) -> ((B, S, d), aux_loss).

    masks: this MoE's mask subtree (mirrors ``p``); the expert banks
    dispatch as grouped kernels, the shared MLP through the 2-D ones.
    pack: the matching PackState subtree (grouped entries for the banks).

    active: optional (B,) bool, the continuous-batching live-slot mask.
    Every (token, slot) assignment competes for the finite per-expert
    capacity C, rank priority to lower rows; an inactive row's assignments
    are relabelled to the sentinel expert id E before the stable rank
    sort, so they order after every real expert's run and are dropped: a
    parked slot's stale token takes no capacity from an active request.
    """
    assert_total_dispatch(masks, _DISPATCHED, kernel=cfg.sparse.kernel, where="moe")
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    dt = xt.dtype
    dev = x.device

    probs, gates, eidx = route(p, xt, cfg)
    C = capacity(T, cfg)
    flat_e = eidx.reshape(-1)  # (T*K,)
    if active is not None:
        tok_act = active[:, None].expand(B, S).reshape(T)
        flat_e = torch.where(tok_act.repeat_interleave(K), flat_e, E)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    run_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    # the sentinel's run (id E) reads run_start[E - 1], as the reference's
    # clamped gather; its ranks are never kept
    rank_sorted = (torch.arange(T * K, device=dev)
                   - run_start[sorted_e.clamp(max=E - 1)])
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    keep = (rank < C) & (flat_e < E)
    dest = torch.where(keep, flat_e * C + rank, E * C)  # overflow -> scratch row
    # duplicate destinations occur only at the scratch row, which is dropped
    buf = torch.zeros(E * C + 1, d, dtype=dt, device=dev).index_copy_(
        0, dest, xt.repeat_interleave(K, dim=0))
    buf = buf[:E * C].reshape(E, C, d)

    # the three banks: ONE grouped launch each under kernel dispatch
    h = grouped_linear(p["wi"]["w"], buf, dt, **dispatch_kw(cfg, masks, "wi", pack))
    g = grouped_linear(p["wg"]["w"], buf, dt, **dispatch_kw(cfg, masks, "wg", pack))
    h = F.silu(g) * h
    out_buf = grouped_linear(p["wo"]["w"], h, dt, **dispatch_kw(cfg, masks, "wo", pack))

    out_flat = out_buf.reshape(E * C, d)
    gathered = torch.where(keep[:, None], out_flat[dest.clamp(max=E * C - 1)], 0.0)
    combined = torch.einsum("tkd,tk->td", gathered.reshape(T, K, d), gates.to(dt))

    if "shared" in p:
        combined = combined + mlp(
            p["shared"], xt, "swiglu",
            masks=None if masks is None else masks["shared"],
            kernel=cfg.sparse.kernel, block=cfg.sparse.kernel_block,
            pack=None if pack is None else pack["shared"],
        )

    # load-balancing auxiliary loss (Switch-style), returned for training:
    # the top-k picks of a row are distinct, so their one-hot sum is a scatter
    me = torch.zeros(T, E, device=dev).scatter_(1, eidx, 1.0).mean(0)
    aux = E * (me * probs.mean(0)).sum() / K
    return combined.reshape(B, S, d), aux
