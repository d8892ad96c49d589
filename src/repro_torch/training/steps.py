"""Train and topology-update steps of the port: ``training/steps.py`` of the
JAX package for the transformer family and its MoE variant, with every
method of the paper's comparison: 'rigl', 'set', 'snfs', 'topkast',
'static', gradual magnitude 'pruning' and 'snip'.

  train_step  every step: the loss on RAW params with the masks threaded
              into the kernels (kernel dispatch) or on pre-masked weights
              (kernel='dense'), microbatch gradient accumulation, the
              optimizer on MASKED gradients with weight decay on the active
              weights, the global gradient norm, and the non-finite guard.
  rigl_step   every delta_t steps (t < t_end): the same backward on the
              full batch, then drop/grow (core/rigl.py) and a reset of the
              grown connections' optimizer state; no optimizer step.
  prune_fn    gradual magnitude pruning to the schedule's target (method
              'pruning', which starts dense), at the loop's prune cadence.
  snip_init   one-shot SNIP masks from one batch's dense gradient
              (method 'snip', at step 0).

Under kernel dispatch with method 'rigl' or 'snfs' the state carries
Top-KAST backward supersets ``bwd_masks`` (B ⊇ A) and the pack's superset
view (the ``bidx`` CSC under block_sparse, the ``{"bwd_mask": B}`` carrier
under masked), so the wgrad kernel returns the dense gradient restricted to
B: the grow scores' side channel (snfs folds it into its dense momentum
``dense_mom`` every step), with no dense matmul anywhere.  Method 'topkast'
carries B under any kernel and trains it: the optimizer and the weight
decay run over B, and the drop/grow is by magnitude inside B.
``refresh_pack`` redraws B and re-packs after every update; for topkast
the weights leaving B are zeroed and their optimizer state reset, and
snfs's ``dense_mom`` is masked to the new B.

With ``sparse.fused_epilogue`` (plain SGD) every dispatched leaf's pack
entry also carries its momentum, a seed and the SGD constants; the fused
wgrad kernel then emits the NEW momentum as the weight gradient (K7 under
block_sparse, K19 under masked; K8 and K20 on an MoE model's expert banks)
and ``apply_opt_fused`` finishes the update.

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
  * Random draws (masks, supersets, SET's and Top-KAST's uniform scores)
    come from ``torch.Generator``s seeded from (seed, purpose, step), not
    the reference's threefry keys.
  * ``snip_init`` takes the sparse layers from the state's masks (the
    reference re-runs ``init_lm`` for its flags; at full width that is a
    second copy of the weights).

Meshes (``mesh=``, a ``launch/mesh.py`` device mesh).  The steps take the
GLOBAL batch (every rank builds the same one from the seed), as the
reference's: the step cuts it into ``cfg.microbatches`` runs and gives each
rank its rows of each run (``launch/sharding.py::shard_batch``); a run
whose rows do not divide the data ranks is kept whole on each, as the
reference's ``batch_shardings`` replicates it.  The loss and gradient stay
the mean over microbatches of each microbatch's mean.

Data parallelism: one bucketed all-reduce over the data ranks (the mean,
flat buffers, not one call per leaf) runs after the microbatch
accumulation and before ``dense_to_sparse_grad``; the loss goes with it.
So the optimizer, the non-finite guard and the drop/grow all read the
GLOBAL dense gradient, identical on every data rank: the reference's
"replica-sync bugs are impossible by construction" (the paper's Appendix
M), and every random draw, from a (seed, purpose, step) generator, is the
same everywhere, so masks, supersets and packs stay identical.

Tensor and expert parallelism over ``model`` (``models/tp.py``): the state
is initialised whole and cut to each rank's shards (``shard_train_state``,
by ``launch/sharding.py::train_specs``); the pack is rebuilt on every rank
from its mask shards.  The forward and backward run under
``tp.model_parallel`` (column- and row-parallel projections, local heads,
expert banks, a vocab-parallel head and loss), each rank's kernels on its
local shapes; the gradient norm sums the sharded leaves' squares over the
model ranks; the optimizer is elementwise on the shards.  The drop/grow,
the superset redraw, pruning and SNIP take each sparse leaf in turn whole
(``gather_leaf``), run the unchanged update with the same generator as
one process (the draws are of the logical shape), and keep the local
slice.  FSDP over more than one data rank, the fused epilogue on a mesh of
more than one rank (its wgrad writes the momentum from the local gradient
before any all-reduce could run), the recurrent and SSM families and a
custom ``loss_fn`` (the char-LM GRU's) under ``model > 1`` raise: ROADMAP
queue A item 9b-ii.

bf16 training (grok-1-314b), as the reference: under ``param_dtype=
'bfloat16'`` the masters are bf16 (``init_lm`` casts them as drawn, before
the masks are drawn and applied), so are their gradients, the masked
gradients and the weight decay's sum; the microbatches accumulate in
``grad_accum_dtype``; ``bf16_grads`` casts f32 masters to bf16 once,
before the loss, so the forward reads their bf16 values and the
cotangents come back in bf16.  Adam with a bf16 state returns f32 moments
from its first update on (``optim.apply_opt``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..configs import validate_sparse_kernel
from ..core.distributions import sparsity_map
from ..core.masks import apply_masks, apply_masks_, flat_index, init_masks, tree_map, tree_paths
from ..core.pruning import PruningSchedule, prune_step, snip_masks
from ..core.pack import (
    build_bwd_carrier,
    build_pack_state,
    refresh_pack_state,
    validate_pack,
)
from ..core.rigl import (
    SparseAlgo,
    dense_to_sparse_grad,
    rigl_update,
    topkast_backward_masks,
)
from ..core.schedules import UpdateSchedule
from ..device import resolve_device
from ..models import tp
from ..launch.mesh import dp_axes, dp_group, dp_size, model_group, model_rank, model_size
from ..launch.sharding import (
    gather_leaf,
    param_specs,
    shard_batch,
    shard_index,
    shard_state,
    sharded_dims,
    slice_leaf,
    spec_paths,
    train_specs,
    whole_leaves,
)
from ..models.layers import assert_total_dispatch
from ..models.model import init_lm, lm_loss
from ..optim.optimizers import (
    apply_opt,
    apply_opt_fused,
    global_norm,
    init_opt,
    reset_connections,
    reset_new_connections,
)

__all__ = [
    "make_algo",
    "needs_bwd_masks",
    "init_train_state",
    "refresh_superset",
    "refresh_pack",
    "repack",
    "make_train_step",
    "make_rigl_step",
    "fused_seed",
    "make_prune_fn",
    "snip_init",
    "shard_train_state",
]

_PORTED_METHODS = ("rigl", "static", "set", "snfs", "topkast", "pruning", "snip")
SNFS_MOMENTUM = 0.9


def _generator(seed: int, purpose: int, step: int, device) -> torch.Generator:
    """The draw stream of one (seed, purpose, step): purpose 0 = masks,
    1 = the initial superset, 2 = a refreshed superset, 3 = a topology
    update."""
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
    rigl and snfs under kernel dispatch (the superset gradient is the grow
    scores' dense-side channel) and for method 'topkast' under any kernel
    (its optimizer trains B, its grow set lives in B)."""
    if sp.method == "pruning" or sp.sparsity == 0.0:
        return False
    dispatch = sp.kernel in ("masked", "block_sparse")
    return sp.method == "topkast" or (dispatch and sp.method in ("rigl", "snfs"))


def _check_ported(cfg):
    sp = cfg.sparse
    if sp.method not in _PORTED_METHODS:
        raise ValueError(f"unknown sparse method {sp.method!r} (one of {_PORTED_METHODS})")


def _check_fused(cfg, opt_cfg, dispatch: bool):
    """The reference's gating of ``sparse.fused_epilogue``: the kernel's
    weight cotangent is the new momentum, which exists only for plain SGD
    single-microbatch steps; anything else raises with the reference's
    wording."""
    bad = []
    if not dispatch:
        bad.append("kernel dispatch off (sparse.kernel is dense/None)")
    if opt_cfg.kind != "sgd":
        bad.append(f"optimizer kind {opt_cfg.kind!r} (need plain sgd)")
    if opt_cfg.nesterov:
        bad.append("nesterov (the kernel epilogue emits plain momentum)")
    if opt_cfg.grad_clip:
        bad.append("grad_clip (the raw gradient never exists to clip)")
    if max(cfg.microbatches, 1) != 1:
        bad.append("microbatches > 1 (the epilogue folds mom ONCE/step)")
    if cfg.sparse.method == "snfs":
        bad.append("method='snfs' (its dense-momentum buffer needs the "
                   "raw superset gradient every step)")
    if cfg.bf16_grads:
        bad.append("bf16_grads (cotangent dtype must match the weights)")
    if cfg.dtype != "float32" and opt_cfg.state_dtype != "bfloat16":
        bad.append(
            f"compute dtype {cfg.dtype!r} with f32 optimizer state (the "
            "kernel would nearest-round momentum to the compute dtype; "
            "use dtype='float32', or opt in to bf16 momentum via "
            "OptConfig.state_dtype='bfloat16' for in-kernel stochastic "
            "rounding)"
        )
    if bad:
        raise ValueError("sparse.fused_epilogue=True is unsupported with: "
                         + "; ".join(bad))


def fused_seed(step: int, leaf: int) -> int:
    """The fused epilogue's seed for one leaf at one step, as the reference's
    ``state["step"] * int32(1000003) + int32(i)``: int32 arithmetic that
    wraps (past step 2147), read as uint32.  ``leaf`` is the leaf's index
    in the reference's flatten order of the mask tree (``flat_index``)."""
    return (step * 1000003 + leaf) & 0xFFFFFFFF


def init_train_state(cfg, opt_cfg, *, seed: int = 0, device=None):
    """Fresh train state on ``device`` (default cuda) -> (state, sparse_flags).

    ``init_lm`` -> ERK sparsities -> block-aligned masks (block mode) ->
    masked params (method 'pruning' starts dense: all-ones masks); Top-KAST
    supersets when ``needs_bwd_masks``; the PackState (with the superset
    view) under kernel='block_sparse'; for 'snfs' the dense momentum
    ``dense_mom``, zeros like every param.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    params, flags = init_lm(cfg, seed, device=dev)
    sp = cfg.sparse
    if sp.method == "pruning" or sp.sparsity == 0.0:
        # dense start: all-ones masks on sparsifiable layers (pruning tightens)
        masks = tree_map(lambda _, p, f: torch.ones(p.shape, dtype=torch.bool,
                                                    device=dev) if f else None,
                         params, flags)
    else:
        smap = sparsity_map(cfg, params, flags)
        if sp.kernel == "block_sparse":
            validate_sparse_kernel(sp)
            # a 3-D expert bank tiles by its trailing two dims
            flat = tree_paths(params)
            bad = [n for n in smap if flat[n].dim() not in (2, 3)
                   or flat[n].shape[-2] % sp.block_shape[0]
                   or flat[n].shape[-1] % sp.block_shape[1]]
            if bad:
                raise ValueError(
                    f"sparse.kernel='block_sparse' with block_shape={sp.block_shape} "
                    f"does not tile these sparsifiable layers: {bad}"
                )
        masks = init_masks(_generator(seed, 0, 0, dev), params, smap,
                           block_shape=sp.block_shape)
        params = apply_masks_(params, masks)
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
    _fresh_pack(state, cfg, sharded=False)
    if sp.method == "snfs":
        state["dense_mom"] = tree_map(lambda _, p: torch.zeros_like(p), params)
    return state, flags


def _fresh_pack(state, cfg, *, sharded: bool) -> None:
    """Build ``state["pack"]`` from its masks and supersets, in place: the
    PackState under block_sparse (``sharded``: of this rank's mask shards,
    any of which may hold no active block), the superset carrier under
    masked."""
    sp = cfg.sparse
    if sp.kernel == "block_sparse" and sp.block_shape is not None:
        state["pack"] = build_pack_state(
            state["masks"], sp.block_shape, slack=sp.pack_width_slack,
            device=state["nonfinite_steps"].device, bwd_masks=state.get("bwd_masks"),
            allow_empty=sharded)
    elif sp.kernel == "masked" and "bwd_masks" in state:
        # the masked kernels take elementwise masks: the superset rides
        # along as the carrier the Top-KAST masked VJP fuses
        state["pack"] = build_bwd_carrier(state["bwd_masks"])


def shard_train_state(state, cfg, mesh):
    """A whole train state (every rank's own ``init_train_state`` or
    restore) -> this rank's shards by ``train_specs`` over ``mesh``'s model
    axis, the pack rebuilt from the mask shards.  The identity without a
    model axis wider than 1 (data parallelism keeps the state whole)."""
    if mesh is None or model_size(mesh) == 1:
        return state
    out = shard_state({k: v for k, v in state.items() if k != "pack"},
                      train_specs(state, cfg, mesh), mesh)
    if "pack" in state:
        _fresh_pack(out, cfg, sharded=True)
    return out


class _Sharding:
    """The model axis of a mesh as the steps use it: the param specs by
    path, which leaves each rank holds a slice of, the model group."""

    def __init__(self, cfg, mesh):
        self.mesh = mesh
        self.n = 1 if mesh is None else model_size(mesh)
        if self.n == 1:
            return
        specs = param_specs(cfg, mesh)
        self.spec_of = spec_paths(specs)
        self.sharded = tree_map(lambda _, s: any("model" in a for _, a in sharded_dims(s)),
                                specs, is_leaf=lambda x: isinstance(x, tuple))
        self.group = model_group(mesh)

    def by_leaf(self, fn, params, masks, *rest):
        """``tree_map(fn, params, masks, *rest)`` with ``fn(name, w, m,
        ...)`` run on whole leaves where ``m`` is not None: every tensor
        argument sharded by the leaf's spec is gathered over the model
        ranks first, one leaf at a time, and every tensor ``fn`` returns
        (alone or in a tuple) is cut back to this rank's slice.  Leaves in
        ``tree_map`` order, the order one process draws in: the
        ``leaf_map`` of ``rigl_update``, ``topkast_backward_masks``,
        ``prune_step`` and ``snip_masks``."""
        if self.n == 1:
            return tree_map(fn, params, masks, *rest)

        def one(name, *leaves):
            if leaves[1] is None:
                return fn(name, *leaves)
            spec = self.spec_of[name]
            whole = [None if t is None else gather_leaf(t, spec, self.mesh) for t in leaves]
            out = fn(name, *whole)
            del whole
            cut = lambda o: slice_leaf(o, spec, self.mesh) if torch.is_tensor(o) else o
            return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)

        return tree_map(one, params, masks, *rest)

    def norm(self, g):
        if self.n == 1:
            return global_norm(g)
        return global_norm(g, sharded=self.sharded, group=self.group)


def refresh_superset(state, cfg, mesh=None):
    """Redraw the backward supersets from the CURRENT masks and params
    (right after every topology update).  For method 'topkast' the weights
    leaving the superset (B_old \\ B_new) are zeroed (in place) and their
    optimizer state reset, so weights outside B stay exactly 0; the snfs
    dense momentum is masked to the new B (in place), so coordinates
    without a gradient channel carry no stale momentum into grow scores.
    No-op without ``bwd_masks``.  On a sharded state (``mesh``) each
    leaf's superset is drawn whole and cut to the local slice."""
    if "bwd_masks" not in state:
        return state
    sp = cfg.sparse
    dev = state["nonfinite_steps"].device
    gen = _generator(state["seed"], 2, state["step"], dev)
    sh = _Sharding(cfg, mesh)
    new_b = topkast_backward_masks(state["params"], state["masks"], sp.backward_extra, gen,
                                   block_shape=sp.block_shape, leaf_map=sh.by_leaf)
    new_state = dict(state, bwd_masks=new_b)
    if sp.method == "topkast":
        leavers = tree_map(lambda _, o, n: None if o is None else o.bool() & ~n.bool(),
                           state["bwd_masks"], new_b)
        tree_map(lambda _, w, lv: None if lv is None else w.masked_fill_(lv, 0),
                 state["params"], leavers)
        new_state["opt"] = reset_connections(state["opt"], leavers)
    if "dense_mom" in state:
        tree_map(lambda _, mo, b: None if b is None else mo.mul_(b.to(mo.dtype)),
                 state["dense_mom"], new_b)
    return new_state


def refresh_pack(state, cfg, mesh=None):
    """Refresh the superset, then ``repack``.  Right after every topology
    update.  No-op without a pack (and, for the superset, without
    ``bwd_masks``).  ``mesh``: the state's mesh, where it is sharded."""
    return repack(refresh_superset(state, cfg, mesh), cfg, mesh)


def repack(state, cfg, mesh=None):
    """Re-pack ``state["pack"]`` from the masks and supersets as they are
    (widths never shrink: the current pack is ``prev``) and validate it, or
    under kernel='masked' rebuild the superset carrier.  A restored state
    goes through this alone: its supersets are the saved ones, so a resumed
    run draws nothing the uninterrupted run did not.  No-op without a
    pack.  ``mesh``: the state's mesh, where it holds shards."""
    if "pack" not in state:
        return state
    if cfg.sparse.kernel == "masked":
        return dict(state, pack=build_bwd_carrier(state["bwd_masks"]))
    pack = refresh_pack_state(
        state["masks"], cfg.sparse.block_shape, prev=state["pack"],
        slack=cfg.sparse.pack_width_slack, bwd_masks=state.get("bwd_masks"),
        device=state["nonfinite_steps"].device,
        allow_empty=mesh is not None and model_size(mesh) > 1)
    validate_pack(pack, where="refresh_pack")
    return dict(state, pack=pack)


_BUCKET_BYTES = 1 << 28  # one all-reduce's flat buffer (a larger leaf goes alone)


def _all_reduce_mean(tensors, group, n: int) -> None:
    """Every tensor replaced, in place, by its mean over ``group``'s ``n``
    ranks: tensors of one dtype are packed in order into flat buffers of
    at most ``_BUCKET_BYTES``, one SUM all-reduce a buffer, then divided
    by n."""
    def flush(bucket):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        o = 0
        for t in bucket:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()

    open_ = {}  # dtype -> (bucket, bytes)
    for t in tensors:
        bucket, size = open_.get(t.dtype, ([], 0))
        if bucket and size + t.nbytes > _BUCKET_BYTES:
            flush(bucket)
            bucket, size = [], 0
        open_[t.dtype] = (bucket + [t], size + t.nbytes)
    for bucket, _ in open_.values():
        flush(bucket)


def _dp_sync(cfg, mesh, *, fused: bool = False, custom_loss: bool = False):
    """``sync(loss, grads) -> (loss, grads)``: their means over the
    data-parallel ranks of ``mesh`` (``_all_reduce_mean``, the grads in
    place: a rank's local shards under tensor parallelism); the identity
    without a mesh.  Refuses what the mesh cannot run yet (ROADMAP queue A
    item 9b-ii): FSDP over more than one data rank, the fused epilogue on
    a mesh of more than one rank, and under ``model > 1`` the recurrent
    and SSM families and a custom loss (the char-LM GRU's)."""
    if mesh is None:
        return lambda loss, g: (loss, g)
    n, n_model = dp_size(mesh), model_size(mesh)
    if cfg.fsdp and n > 1:
        raise NotImplementedError(
            f"config {cfg.name!r} sets fsdp=True: sharding weights over the {n} data "
            "ranks is ROADMAP queue A item 9b-ii; set fsdp=False for data parallelism")
    if fused and mesh.size() > 1:
        raise ValueError(
            f"sparse.fused_epilogue on a mesh of {mesh.size()} ranks: the fused wgrad "
            "writes the momentum from each rank's local gradient before any all-reduce "
            "could run (ROADMAP queue A item 9b-ii)")
    if n_model > 1 and (cfg.block_type in ("xlstm", "hymba") or custom_loss):
        what = (f"block_type {cfg.block_type!r}" if not custom_loss
                else "a custom loss_fn (the char-LM GRU's)")
        raise NotImplementedError(
            f"config {cfg.name!r} on model={n_model}: tensor parallelism for {what} is "
            "ROADMAP queue A item 9b-ii")
    if n == 1 and n_model > 1:  # no data peers: nothing to average
        return lambda loss, g: (loss, g)
    group = dp_group(mesh)

    def sync(loss, g):
        _all_reduce_mean([loss] + _leaves(g), group, n)
        return loss, g

    return sync


def _on_rows(fn, src, batch, mesh):
    """``_value_and_grad(fn, src, ...)`` on this rank's rows of a global
    (micro)batch (``shard_batch``), under ``tp.data_parallel`` where the
    rows are cut (the MoE routes as the whole batch does) and
    ``tp.model_parallel``."""
    if mesh is None:
        return _value_and_grad(fn, src, batch)
    rows = shard_batch(batch, mesh)
    cut = None
    if rows["targets"].shape[0] != batch["targets"].shape[0]:
        cut = (dp_group(mesh), *shard_index(mesh, dp_axes(mesh)))
    with (tp.model_parallel(model_group(mesh), model_size(mesh), model_rank(mesh)),
          tp.data_parallel(cut)):
        return _value_and_grad(fn, src, rows)


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


def _loss_fn(loss_fn, state, dispatch, pack=None):
    if not dispatch:
        return lambda p, b: loss_fn(p, b)
    pack = state.get("pack") if pack is None else pack
    return lambda p, b: loss_fn(p, b, masks=state["masks"], pack=pack)


def _fused_pack(state, opt_cfg):
    """The state's pack with the SGD epilogue's operands merged into every
    mask leaf's entry: ``{"mom", "seed", "mu", "wd", "sr"}`` (the
    reference's per-trace fused entries; sr when the state is bf16)."""
    index = flat_index(state["masks"])
    consts = {"mu": opt_cfg.momentum, "wd": opt_cfg.weight_decay,
              "sr": opt_cfg.state_dtype == "bfloat16"}
    pack = state.get("pack") or tree_map(lambda *_: None, state["masks"])
    return tree_map(
        lambda n, m, pe, mo: None if m is None else dict(
            pe or {}, mom=mo, seed=fused_seed(state["step"], index[n]), **consts),
        state["masks"], pack, state["opt"]["momentum"])


def make_train_step(cfg, opt_cfg, lr_sched, *, loss_fn=None, mesh=None):
    """Build ``train_step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place (see the module docstring) and the
    metrics are device tensors: reading them is the caller's sync.  Under
    ``mesh`` the batch is the GLOBAL batch, cut into microbatches and then
    into this rank's rows of each, the state this rank's shards
    (``shard_train_state``); the gradient and loss are the data-parallel
    means (``_dp_sync``).  ``train_step.grads(state, batch)`` is the
    step's (loss, dense gradient) alone, after the all-reduce (tests read
    it).  ``loss_fn(params, batch, masks=None, pack=None)`` defaults to
    ``lm_loss``, as in the reference.  Method 'topkast' optimizes (and
    decays) the superset B; 'snfs' folds the gradient before masking (the
    superset gradient under dispatch) into ``dense_mom`` as ``0.9 * m +
    g``, in place under the non-finite guard."""
    dispatch = cfg.sparse.kernel not in (None, "dense")
    is_topkast = cfg.sparse.method == "topkast"
    fused = dispatch and cfg.sparse.fused_epilogue
    if cfg.sparse.fused_epilogue:
        _check_fused(cfg, opt_cfg, dispatch)
    _check_ported(cfg)
    if dispatch:
        validate_sparse_kernel(cfg.sparse)
    mb = max(cfg.microbatches, 1)
    acc_dt = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" else torch.float32
    opt_nowd = dataclasses.replace(opt_cfg, weight_decay=0.0)
    sync = _dp_sync(cfg, mesh, fused=fused, custom_loss=loss_fn is not None)
    loss_fn = loss_fn or _default_loss(cfg)
    sh = _Sharding(cfg, mesh)
    if sh.n > 1 and dist.get_rank() == 0:
        whole = whole_leaves(cfg, mesh)
        print(f"[train] model={sh.n}: block-sparse leaves held whole, run replicated "
              f"(a shard would split a block): {whole or 'none'}")

    def grads(state, batch, pack=None):
        src = state["params"] if dispatch else apply_masks(state["params"], state["masks"])
        if cfg.bf16_grads:
            # one downcast of the f32 masters: the forward reads their bf16
            # values and the cotangents come back in bf16
            src = tree_map(lambda _, w: w.to(torch.bfloat16) if w.dtype == torch.float32
                           else w, src)
        fn = _loss_fn(loss_fn, state, dispatch, pack)
        if mb == 1:
            return _on_rows(fn, src, batch, mesh)
        # the reference's split: microbatches of the GLOBAL batch, each then
        # cut into this rank's rows
        bsz = batch["targets"].shape[0] // mb
        loss_acc, g_acc = torch.zeros((), dtype=torch.float32), None
        for i in range(mb):
            li, gi = _on_rows(fn, src, {k: v[i * bsz:(i + 1) * bsz] for k, v in batch.items()},
                              mesh)
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
        # fused: the dispatched leaves' gradients come back as the NEW
        # momentum m_new = mu*mom + dw + wd*w (K7, K8, K19 or K20), masked
        # to the wgrad support; the raw gradient never exists
        loss, g_dense = sync(*grads(state, batch,
                                    _fused_pack(state, opt_cfg) if fused else None))
        # topkast trains the whole superset B; every other method A only
        opt_masks = state["bwd_masks"] if is_topkast else state["masks"]
        g = dense_to_sparse_grad(g_dense, opt_masks)
        if "dense_mom" in state:
            # the decay below adds into g in place: keep g_dense's dense
            # leaves (which g shares) raw for the momentum
            g = tree_map(lambda _, t, m: t.clone() if m is None else t, g, opt_masks)
        else:
            del g_dense
        if opt_cfg.weight_decay:
            # decay on the OPTIMIZED weights only (A, or B for topkast;
            # the others must stay untouched); folded into the kernel's
            # epilogue on fused leaves
            wd = opt_cfg.weight_decay
            tree_map(lambda _, g_, w, m: None if fused and m is not None else g_.add_(
                wd * (w if m is None else w * m.to(w.dtype)).to(g_.dtype)),
                g, state["params"], opt_masks)
        lr = lr_sched(state["step"])
        # fused: the norm of the momentum update on the fused leaves (the
        # reference's too); finite iff the gradient contribution is
        gnorm = sh.norm(g)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if fused:
            flags = tree_map(lambda _, m: m is not None, state["masks"])
            apply_opt_fused(opt_nowd, g, state["opt"], state["params"], lr, flags, ok=ok)
        else:
            apply_opt(opt_nowd, g, state["opt"], state["params"], lr, ok=ok, gnorm=gnorm)
        if "dense_mom" in state:  # SNFS tracks the dense-gradient momentum
            tree_map(lambda _, mo, gd: mo.copy_(torch.where(
                ok, SNFS_MOMENTUM * mo + gd.to(mo.dtype), mo)), state["dense_mom"], g_dense)
        nonfinite = state["nonfinite_steps"] + (~ok).to(torch.int32)
        state = dict(state, step=state["step"] + 1, nonfinite_steps=nonfinite)
        return state, {"loss": loss, "lr": lr, "grad_norm": gnorm,
                       "nonfinite_steps": nonfinite}

    train_step.grads = lambda state, batch: sync(*grads(state, batch))
    return train_step


def make_rigl_step(cfg, algo: SparseAlgo, lr_sched, *, mesh=None):
    """Build ``rigl_step(state, batch) -> (state, metrics)``: the full-batch
    gradient (superset-restricted under dispatch), ``rigl_update`` (with
    the state's dense momentum and supersets) and the reset of the grown
    connections' optimizer state.  Follow every call with
    ``refresh_pack``.  Under ``mesh`` the batch is the global batch (this
    rank takes its rows) and the drop/grow reads the data-parallel mean
    gradient, the same on every data rank; on a sharded state each sparse
    leaf is updated whole, with the one process's draws, and cut back."""
    _check_ported(cfg)
    dispatch = cfg.sparse.kernel not in (None, "dense")
    loss_fn = _default_loss(cfg)
    sync = _dp_sync(cfg, mesh)
    sh = _Sharding(cfg, mesh)

    def rigl_step(state, batch):
        if dispatch and "bwd_masks" in state:
            loss, g = _on_rows(_loss_fn(loss_fn, state, True), state["params"], batch, mesh)
        else:
            loss, g = _on_rows(_loss_fn(loss_fn, state, False),
                               apply_masks(state["params"], state["masks"]), batch, mesh)
        loss, g = sync(loss, g)
        dev = state["nonfinite_steps"].device
        gen = _generator(state["seed"], 3, state["step"], dev)
        params, masks, grown = rigl_update(
            state["params"], state["masks"], g, state["step"], algo, gen,
            dense_momentum=state.get("dense_mom"), bwd_masks=state.get("bwd_masks"),
            lr=float(lr_sched.base_lr), leaf_map=sh.by_leaf)
        # the gradients are spent: free them before the reset builds the
        # new optimizer state (a full-width grok layer's are 13 GB)
        del g
        opt = reset_new_connections(state["opt"], grown)
        return dict(state, step=state["step"] + 1, params=params, masks=masks,
                    opt=opt), {"loss": loss}

    return rigl_step


def make_prune_fn(cfg, sched: PruningSchedule, *, mesh=None):
    """Build ``prune_fn(state) -> state``: gradual magnitude pruning of every
    masked layer to ``sched.target(state["step"])``.  Follow every call
    with ``refresh_pack``.  On a sharded state (``mesh``) each layer is
    pruned whole and cut back."""
    sh = _Sharding(cfg, mesh)

    def fn(state):
        params, masks = prune_step(state["params"], state["masks"], state["step"], sched,
                                   leaf_map=sh.by_leaf)
        return dict(state, params=params, masks=masks)

    return fn


def snip_init(state, cfg, batch, *, loss_fn=None, saliency: str = "weight_times_grad",
              mesh=None):
    """Replace the masks with one-shot SNIP masks from one batch's dense
    gradient of the loss on the current params (no masks threaded, as in
    the reference), at the config's per-layer sparsities; the params are
    masked.  The sparse layers are those the state's masks cover.  Under
    ``mesh`` the batch is the global batch (this rank takes its rows), the
    saliency reads the data-parallel mean gradient, and on a sharded state
    each layer's saliency is ranked whole and cut back."""
    sync = _dp_sync(cfg, mesh, custom_loss=loss_fn is not None)
    loss_fn = loss_fn or (lambda p, b: lm_loss(p, cfg, b))
    sh = _Sharding(cfg, mesh)
    flags = tree_map(lambda _, m: m is not None, state["masks"])
    _, g = sync(*_on_rows(loss_fn, state["params"], batch, mesh))
    # the sparsities are a function of the logical (whole) shapes
    smap = sparsity_map(cfg, state["params"] if sh.n == 1 else _logical_params(cfg), flags)
    g = tree_map(lambda n, t: t if n in smap else None, g)
    masks = snip_masks(state["params"], g, smap, saliency=saliency, leaf_map=sh.by_leaf)
    del g
    return dict(state, params=apply_masks(state["params"], masks), masks=masks)


def _logical_params(cfg):
    """The whole params' shapes, as meta tensors (the per-layer sparsities
    are a function of the logical shapes)."""
    from ..models.model import lm_layout

    return lm_layout(cfg)[0]
