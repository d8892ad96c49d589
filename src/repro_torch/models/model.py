"""Dense-family transformer LM of the port: init, loss, prefill and decode.

Port of the JAX package's ``models/model.py`` for training and serving the
transformer family (h2o-danube-1.8b).  Every weight matmul goes through
``layers.linear`` (the block-sparse kernels under
``cfg.sparse.kernel='block_sparse'``, forward and backward), full-sequence
attention through the flash kernels, decode attention and the LM head are
plain PyTorch.  ``lm_loss`` is differentiable; with ``cfg.remat`` each
group of ``cfg.remat_group`` blocks is a ``torch.utils.checkpoint`` region
(the reference's ``jax.checkpoint``): it changes memory, not numbers.

Dtypes follow the reference's actual flow: the embedding is gathered in the
compute dtype and scaled by sqrt(d_model) into an f32 residual stream
(NumPy's float64 scalar promotes it there in the reference), rmsnorm keeps
the residual's dtype, the attention projections cast to ``cfg.dtype`` (and
``wo`` inherits the attention output's dtype), while the MLP and the LM head
inherit the residual's f32.  Under a bf16 config the MLP's block-sparse
matmuls therefore run in f32, forward and backward, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as A
from .layers import (
    P,
    compute_dtype,
    linear,
    linear_init,
    rmsnorm,
    rmsnorm_init,
    split_params,
)
from .mlp import mlp, mlp_init

__all__ = [
    "padded_vocab",
    "init_lm",
    "serving_weights",
    "lm_forward",
    "lm_loss",
    "init_caches",
    "lm_prefill",
    "lm_prefill_into",
    "lm_decode",
    "logits_all_finite",
]


def padded_vocab(cfg) -> int:
    """Vocab padded to a multiple of 256; pad logits are masked in _logits."""
    return ((cfg.vocab_size + 255) // 256) * 256


def _check_ported(cfg) -> None:
    unported = {
        "block_type": cfg.block_type != "transformer",
        "n_experts": bool(cfg.n_experts),
        "frontend": cfg.frontend != "none",
        "parallel_block": cfg.parallel_block,
        "post_norms": cfg.post_norms,
        "qk_norm": cfg.qk_norm,
        "mlp_kind": cfg.mlp_kind != "swiglu",
        "tie_embeddings": cfg.tie_embeddings,
        "causal": not cfg.causal,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"config {cfg.name!r}: {', '.join(bad)} not ported yet (the port "
            "serves the dense-family causal transformer)"
        )


def init_lm(cfg, seed: int = 0, *, device=None):
    """Random weights from ``seed`` -> (params, sparse_flags) trees, f32
    masters on ``device`` (default ``cuda``).  Layout as the reference's
    ``init_lm``; the draws are torch's, not ``jax.random``'s."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, pv = cfg.d_model, padded_vocab(cfg)
    tree = {
        "embed": {"table": P(0.02 * torch.randn(pv, d, generator=gen, device=dev))},
        "layers": [
            {
                "ln1": rmsnorm_init(d, dev),
                "attn": A.attn_init(gen, cfg),
                "ln2": rmsnorm_init(d, dev),
                "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind),
            }
            for _ in range(cfg.n_layers)
        ],
        "ln_f": rmsnorm_init(d, dev),
        "head": linear_init(gen, d, pv, sparse=False),
    }
    return split_params(tree)


def serving_weights(params, cfg):
    """The params with the embedding table and the attention weights cast to
    the compute dtype, ONCE.  The reference casts the f32 masters inside
    every call (``layers.linear``, the embedding gather); casting once gives
    the same bits without re-reading f32 weights on every decode step.  The
    MLP weights, norm scales and the LM head stay f32: the reference
    computes them in the f32 residual's dtype."""
    dt = compute_dtype(cfg)
    out = dict(params)
    out["embed"] = {"table": params["embed"]["table"].to(dt)}
    out["layers"] = [
        dict(lp, attn={name: {"w": w["w"].to(dt)} for name, w in lp["attn"].items()})
        for lp in params["layers"]
    ]
    return out


def _sub(tree, key):
    return None if tree is None else tree[key]


def _per_layer(tree, cfg):
    return tree["layers"] if tree is not None else [None] * cfg.n_layers


def _embed(params, cfg, tokens):
    x = params["embed"]["table"].to(compute_dtype(cfg))[tokens]
    return x.float() * float(np.float32(np.sqrt(cfg.d_model)))


def _block(p, x, cfg, i, *, positions=None, masks=None, pack=None):
    """Full-sequence block (prefill).  Returns (x, (k, v))."""
    kind = cfg.layer_kind(i)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, kv = A.attention(
        p["attn"], h, cfg, kind=kind, positions=positions,
        masks=_sub(masks, "attn"), pack=_sub(pack, "attn"),
    )
    x = x + attn_out
    ff_out = mlp(
        p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp_kind,
        masks=_sub(masks, "mlp"), kernel=cfg.sparse.kernel,
        block=cfg.sparse.kernel_block, pack=_sub(pack, "mlp"),
    )
    return x + ff_out, kv


def _logits(params, cfg, h):
    out = linear(params["head"], h, h.dtype).float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        out = c * torch.tanh(out / c)
    pad = out.shape[-1] - cfg.vocab_size
    if pad:  # mask vocab-padding slots (out of place: autograd may need out)
        out = torch.cat([out[..., :cfg.vocab_size],
                         out.new_full((*out.shape[:-1], pad), -1e30)], dim=-1)
    return out


def lm_forward(params, cfg, batch, *, masks=None, pack=None, positions=None,
               collect_states: bool = True):
    """Full-sequence forward -> (hidden (B, S, d), per-layer (k, v)).

    Without ``collect_states`` (the loss) and with ``cfg.remat`` under
    autograd, each group of ``cfg.remat_group`` blocks runs as one
    checkpoint region: only its input is saved and its forward reruns in
    the backward (so the forward kernels launch twice per step).  The
    states list is then empty, as in the reference."""
    _check_ported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    layers = list(zip(params["layers"], _per_layer(masks, cfg), _per_layer(pack, cfg)))
    states = []
    if cfg.remat and not collect_states and torch.is_grad_enabled():
        g = max(cfg.remat_group, 1)

        def region(i0, x_):
            for j, (p, m, pk) in enumerate(layers[i0:i0 + g]):
                x_, _ = _block(p, x_, cfg, i0 + j, positions=positions, masks=m, pack=pk)
            return x_

        for i0 in range(0, cfg.n_layers, g):
            x = checkpoint(region, i0, x, use_reentrant=False)
    else:
        for i, (p, m, pk) in enumerate(layers):
            x, kv = _block(p, x, cfg, i, positions=positions, masks=m, pack=pk)
            if collect_states:
                states.append(kv)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), states


def lm_loss(params, cfg, batch, masks=None, pack=None):
    """Mean next-token cross-entropy (chunked over the sequence by
    ``cfg.loss_chunks`` to bound the logits buffer), as the reference's
    ``lm_loss``.  With ``masks`` the params are RAW and the topology is
    enforced inside the kernels, so autograd of this w.r.t. the params
    yields the sparse (or superset-supported) gradient directly."""
    h, _ = lm_forward(params, cfg, batch, masks=masks, pack=pack,
                      collect_states=False)
    targets = batch["targets"]
    B, S, _ = h.shape
    n_chunks = max(1, cfg.loss_chunks)
    if S % n_chunks:
        raise ValueError(f"lm_loss: seq {S} does not split into {n_chunks} chunks")
    step = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, S, step):
        logits = _logits(params, cfg, h[:, s:s + step])
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets[:, s:s + step, None].long())[..., 0]
        total = total + (lse - picked).sum()
    return total / (B * S)


def init_caches(cfg, batch: int, max_len: int, device):
    """Per-layer KV caches in the compute dtype."""
    dt = compute_dtype(cfg)
    return [
        {"kv": A.init_kv_cache(cfg, cfg.layer_kind(i), batch, max_len, dt, device)}
        for i in range(cfg.n_layers)
    ]


def lm_prefill(params, cfg, batch, max_len: int, *, masks=None, pack=None,
               n_valid=None):
    """Run the prompt -> (last-position logits (B, 1, V), filled caches).

    ``n_valid``: positions >= n_valid are end padding (the engine buckets
    prompt lengths): their K/V writes are dropped and the logits come from
    position n_valid - 1.  Exact for causal attention stacks.
    """
    h, states = lm_forward(params, cfg, batch, masks=masks, pack=pack)
    caches = init_caches(cfg, h.shape[0], max_len, h.device)
    for c, (k, v) in zip(caches, states):
        A.fill_kv_cache(c["kv"], k, v, 0, n_valid=n_valid)
    last = h.shape[1] if n_valid is None else n_valid
    return _logits(params, cfg, h[:, last - 1:last]), caches


def lm_prefill_into(params, cfg, caches, batch, slot: int, max_len: int, *,
                    masks=None, pack=None, n_valid=None):
    """Prefill ONE prompt (B=1) and write its cache row into ``caches`` at
    ``slot``, in place; stale positions beyond the prompt stay, since decode
    never attends a position before the write that owns it.  Returns
    (logits (1, 1, V), caches)."""
    logits, row = lm_prefill(params, cfg, batch, max_len, masks=masks,
                             pack=pack, n_valid=n_valid)
    for c, r in zip(caches, row):
        for name in ("k", "v"):
            c["kv"][name][slot] = r["kv"][name][0]
    return logits, caches


def logits_all_finite(logits):
    """(B, ...) -> (B,) bool: every logit of the row is finite (vocab pads
    are the finite -1e30, so a NaN/Inf is a real fault on that slot)."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)


def lm_decode(params, cfg, caches, tokens, pos, *, masks=None, pack=None,
              active=None):
    """One decode step.  tokens: (B, 1) int; pos: int or (B,) tensor;
    ``active`` (B,) bool leaves inactive rows' caches untouched.  Returns
    (logits (B, 1, V), caches updated in place)."""
    _check_ported(cfg)
    x = _embed(params, cfg, tokens)
    for i, (p, m, pk, c) in enumerate(zip(
            params["layers"], _per_layer(masks, cfg), _per_layer(pack, cfg),
            caches)):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn_out, c["kv"] = A.attn_decode(
            p["attn"], h, c["kv"], pos, cfg, kind=cfg.layer_kind(i),
            masks=_sub(m, "attn"), pack=_sub(pk, "attn"), active=active,
        )
        x = x + attn_out
        x = x + mlp(
            p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.mlp_kind,
            masks=_sub(m, "mlp"), kernel=cfg.sparse.kernel,
            block=cfg.sparse.kernel_block, pack=_sub(pk, "mlp"),
        )
    return _logits(params, cfg, rmsnorm(params["ln_f"], x, cfg.norm_eps)), caches
