"""Train and topology-update steps of the port: ``training/steps.py`` of the
JAX package for the transformer family, methods 'rigl' and 'static'.

  train_step  every step: the loss on RAW params with the masks threaded
              into the kernels (kernel dispatch) or on pre-masked weights
              (kernel='dense'), microbatch gradient accumulation, the
              optimizer on MASKED gradients with weight decay on the active
              weights, the global gradient norm, and the non-finite guard.
  rigl_step   every delta_t steps (t < t_end): the same backward on the
              full batch, then drop/grow (core/rigl.py) and a reset of the
              grown connections' optimizer state; no optimizer step.

Under kernel dispatch with method='rigl' the state carries Top-KAST
backward supersets ``bwd_masks`` (B ⊇ A) and the pack's ``bidx`` view, so
the wgrad kernel returns the dense gradient restricted to B: the grow
scores' side channel, with no dense matmul anywhere.  ``refresh_pack``
redraws B and re-packs after every update.

Differences from the reference, each for the card:
  * The step updates params and optimizer state IN PLACE (the reference's
    functions are pure): a full-width model cannot hold a second copy of
    its f32 params and Adam moments beside the gradients.  The non-finite
    guard stays exact: every leaf takes ``where(ok, new, old)``, decided on
    the device, with no host sync.
  * ``state["step"]`` is a host int (the loop branches on it anyway);
    ``nonfinite_steps`` is a device counter.
  * ``pack_stale`` is not computed inside the step: ``launch/train.py``
    checks ``core.pack.pack_mismatch`` at log cadence, where the reference
    reads it (staleness is sticky until the next refresh).
  * Random draws (masks, supersets) come from ``torch.Generator``s seeded
    from (seed, purpose, step), not the reference's threefry keys.

Not ported yet (they raise): methods set/snfs/topkast/pruning/snip, the
fused SGD epilogue (K7/K19), kernel='masked', bf16 params or gradients.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import validate_sparse_kernel
from ..core.distributions import sparsity_map
from ..core.masks import apply_masks, init_masks, tree_map, tree_paths
from ..core.pack import build_pack_state, refresh_pack_state, validate_pack
from ..core.rigl import (
    SparseAlgo,
    dense_to_sparse_grad,
    rigl_update,
    topkast_backward_masks,
)
from ..core.schedules import UpdateSchedule
from ..device import resolve_device
from ..models.layers import assert_total_dispatch
from ..models.model import init_lm, lm_loss
from ..optim.optimizers import apply_opt, global_norm, init_opt, reset_new_connections

__all__ = [
    "make_algo",
    "needs_bwd_masks",
    "init_train_state",
    "refresh_superset",
    "refresh_pack",
    "make_train_step",
    "make_rigl_step",
]

_PORTED_METHODS = ("rigl", "static")


def _not_ported(what: str):
    return NotImplementedError(f"training: {what} is not ported yet")


def _generator(seed: int, purpose: int, step: int, device) -> torch.Generator:
    """The draw stream of one (seed, purpose, step): purpose 0 = masks,
    1 = the initial superset, 2 = a refreshed superset, 3 = a RigL update."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + purpose) * 1_000_033 + step)


def make_algo(cfg, total_steps: int) -> SparseAlgo:
    sp = cfg.sparse
    return SparseAlgo(
        method=sp.method,
        schedule=UpdateSchedule(delta_t=sp.delta_t,
                                t_end=int(sp.t_end_fraction * total_steps),
                                alpha=sp.alpha),
        grow_init=sp.grow_init,
        block_shape=sp.block_shape,
        backward_extra=sp.backward_extra,
    )


def needs_bwd_masks(sp) -> bool:
    """Does this config's state carry Top-KAST backward supersets?  Yes for
    rigl (and snfs, not ported) under kernel dispatch: the superset
    gradient is the grow scores' dense-side channel, and for method
    'topkast' (not ported)."""
    if sp.method == "pruning" or sp.sparsity == 0.0:
        return False
    dispatch = sp.kernel in ("masked", "block_sparse")
    return sp.method == "topkast" or (dispatch and sp.method in ("rigl", "snfs"))


def _check_ported(cfg, opt_cfg=None):
    sp = cfg.sparse
    if sp.method not in _PORTED_METHODS:
        raise _not_ported(f"method {sp.method!r} (the port trains 'rigl' and 'static')")
    if sp.kernel == "masked":
        raise _not_ported("kernel='masked' (the fused-mask matmul kernels)")
    if sp.fused_epilogue:
        raise _not_ported("sparse.fused_epilogue (apply_opt_fused, kernels K7/K19)")
    if cfg.param_dtype != "float32" or cfg.bf16_grads:
        raise _not_ported("bf16 params or gradients")
    if opt_cfg is not None and opt_cfg.state_dtype != "float32":
        raise _not_ported("bf16 optimizer state")


def init_train_state(cfg, opt_cfg, *, seed: int = 0, device=None):
    """Fresh train state on ``device`` (default cuda) -> (state, sparse_flags).

    ``init_lm`` -> ERK sparsities -> block-aligned masks (block mode) ->
    masked params; Top-KAST supersets when ``needs_bwd_masks``; the
    PackState (with the superset view) under kernel='block_sparse'.
    """
    _check_ported(cfg, opt_cfg)
    dev = resolve_device(device)
    params, flags = init_lm(cfg, seed, device=dev)
    sp = cfg.sparse
    if sp.sparsity == 0.0:
        masks = tree_map(lambda _, p, f: torch.ones(p.shape, dtype=torch.bool,
                                                    device=dev) if f else None,
                         params, flags)
    else:
        smap = sparsity_map(cfg, params, flags)
        if sp.kernel == "block_sparse":
            validate_sparse_kernel(sp)
            flat = tree_paths(params)
            bad = [n for n in smap if flat[n].dim() != 2
                   or flat[n].shape[0] % sp.block_shape[0]
                   or flat[n].shape[1] % sp.block_shape[1]]
            if bad:
                raise ValueError(
                    f"sparse.kernel='block_sparse' with block_shape={sp.block_shape} "
                    f"does not tile these sparsifiable layers: {bad}"
                )
        masks = init_masks(_generator(seed, 0, 0, dev), params, smap,
                           block_shape=sp.block_shape)
        params = apply_masks(params, masks)
    state = {
        "step": 0,
        "seed": seed,
        "params": params,
        "masks": masks,
        "opt": init_opt(opt_cfg, params, device=dev),
        "nonfinite_steps": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if needs_bwd_masks(sp):
        state["bwd_masks"] = topkast_backward_masks(
            params, masks, sp.backward_extra, _generator(seed, 1, 0, dev),
            block_shape=sp.block_shape)
    if sp.kernel == "block_sparse" and sp.block_shape is not None:
        state["pack"] = build_pack_state(
            masks, sp.block_shape, slack=sp.pack_width_slack, device=dev,
            bwd_masks=state.get("bwd_masks"))
    return state, flags


def refresh_superset(state, cfg):
    """Redraw the backward supersets from the CURRENT masks and params
    (right after every topology update).  No-op without ``bwd_masks``."""
    if "bwd_masks" not in state:
        return state
    sp = cfg.sparse
    dev = state["nonfinite_steps"].device
    new_b = topkast_backward_masks(
        state["params"], state["masks"], sp.backward_extra,
        _generator(state["seed"], 2, state["step"], dev), block_shape=sp.block_shape)
    return dict(state, bwd_masks=new_b)


def refresh_pack(state, cfg):
    """Refresh the superset, then re-pack ``state["pack"]`` from the masks
    (widths never shrink) and validate it.  No-op without a pack."""
    state = refresh_superset(state, cfg)
    if "pack" not in state:
        return state
    pack = refresh_pack_state(
        state["masks"], cfg.sparse.block_shape, prev=state["pack"],
        slack=cfg.sparse.pack_width_slack, bwd_masks=state.get("bwd_masks"),
        device=state["nonfinite_steps"].device)
    validate_pack(pack, where="refresh_pack")
    return dict(state, pack=pack)


def _leaves(tree):
    out = []
    tree_map(lambda _, t: out.append(t) if t is not None else None, tree)
    return out


def _like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _, t: None if t is None else next(it), tree)


def _value_and_grad(loss_fn, src, batch):
    """(loss, grads tree mirroring ``src``) of loss_fn(params, batch)."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(src)]
    loss = loss_fn(_like(src, leaves), batch)
    return loss.detach(), _like(src, torch.autograd.grad(loss, leaves))


def _default_loss(cfg):
    return lambda p, b, masks=None, pack=None: lm_loss(p, cfg, b, masks=masks, pack=pack)


def _loss_fn(loss_fn, state, dispatch):
    if not dispatch:
        return lambda p, b: loss_fn(p, b)
    return lambda p, b: loss_fn(p, b, masks=state["masks"], pack=state.get("pack"))


def make_train_step(cfg, opt_cfg, lr_sched, *, loss_fn=None):
    """Build ``train_step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place (see the module docstring) and the
    metrics are device tensors: reading them is the caller's sync.
    ``loss_fn(params, batch, masks=None, pack=None)`` defaults to
    ``lm_loss``, as in the reference."""
    _check_ported(cfg, opt_cfg)
    dispatch = cfg.sparse.kernel not in (None, "dense")
    if dispatch:
        validate_sparse_kernel(cfg.sparse)
    mb = max(cfg.microbatches, 1)
    acc_dt = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" else torch.float32
    opt_nowd = dataclasses.replace(opt_cfg, weight_decay=0.0)
    loss_fn = loss_fn or _default_loss(cfg)

    def grads(state, batch):
        src = state["params"] if dispatch else apply_masks(state["params"], state["masks"])
        fn = _loss_fn(loss_fn, state, dispatch)
        if mb == 1:
            return _value_and_grad(fn, src, batch)
        bsz = batch["tokens"].shape[0] // mb
        loss_acc, g_acc = torch.zeros((), dtype=torch.float32), None
        for i in range(mb):
            sub = {k: v[i * bsz:(i + 1) * bsz] for k, v in batch.items()}
            li, gi = _value_and_grad(fn, src, sub)
            loss_acc = loss_acc.to(li.device) + li
            if g_acc is None:
                g_acc = tree_map(lambda _, g: torch.zeros(g.shape, dtype=acc_dt,
                                                          device=g.device), gi)
            tree_map(lambda _, a, g: a.add_(g.to(acc_dt)), g_acc, gi)
            del gi
        inv = 1.0 / mb
        tree_map(lambda _, g: g.mul_(inv), g_acc)
        return loss_acc * inv, g_acc

    def train_step(state, batch):
        if dispatch and needs_bwd_masks(cfg.sparse):
            assert_total_dispatch(state["masks"], kernel=cfg.sparse.kernel,
                                  where="train_step", pack=state.get("pack"))
        loss, g = grads(state, batch)
        g = dense_to_sparse_grad(g, state["masks"])
        if opt_cfg.weight_decay:
            # decay on the ACTIVE weights only (inactive must stay untouched)
            wd = opt_cfg.weight_decay
            tree_map(lambda _, g_, w, m: g_.add_(wd * (w if m is None else
                                                       w * m.to(w.dtype)).to(g_.dtype)),
                     g, state["params"], state["masks"])
        lr = lr_sched(state["step"])
        gnorm = global_norm(g)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        apply_opt(opt_nowd, g, state["opt"], state["params"], lr, ok=ok, gnorm=gnorm)
        nonfinite = state["nonfinite_steps"] + (~ok).to(torch.int32)
        state = dict(state, step=state["step"] + 1, nonfinite_steps=nonfinite)
        return state, {"loss": loss, "lr": lr, "grad_norm": gnorm,
                       "nonfinite_steps": nonfinite}

    return train_step


def make_rigl_step(cfg, algo: SparseAlgo, lr_sched):
    """Build ``rigl_step(state, batch) -> (state, metrics)``: the full-batch
    gradient (superset-restricted under dispatch), ``rigl_update`` and the
    reset of the grown connections' optimizer state.  Follow every call
    with ``refresh_pack``."""
    _check_ported(cfg)
    dispatch = cfg.sparse.kernel not in (None, "dense")
    loss_fn = _default_loss(cfg)

    def rigl_step(state, batch):
        if dispatch and "bwd_masks" in state:
            loss, g = _value_and_grad(_loss_fn(loss_fn, state, True),
                                      state["params"], batch)
        else:
            loss, g = _value_and_grad(_loss_fn(loss_fn, state, False),
                                      apply_masks(state["params"], state["masks"]),
                                      batch)
        dev = state["nonfinite_steps"].device
        params, masks, grown = rigl_update(
            state["params"], state["masks"], g, state["step"], algo,
            _generator(state["seed"], 3, state["step"], dev),
            lr=float(lr_sched.base_lr))
        opt = reset_new_connections(state["opt"], grown)
        return dict(state, step=state["step"] + 1, params=params, masks=masks,
                    opt=opt), {"loss": loss}

    return rigl_step
