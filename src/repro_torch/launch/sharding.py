"""Logical-axis -> mesh sharding resolution with divisibility fallback:
the reference's ``launch/sharding.py``, returning spec trees.

Every param and activation dim carries a logical axis name
(``models/*.py``: ``lm_axes``).  The resolver walks a priority list,
assigning mesh axes greedily:

  - a mesh axis is used at most once per array;
  - an assignment is skipped unless the dim is exactly divisible;
  - first fit in PRIORITY order, so MoE expert banks put "model" on the
    experts dim when E divides it (expert parallelism) and otherwise fall
    through to the ff dim (tensor parallelism inside each expert).

FSDP: weight "embed" dims also shard over the ``data`` axis (inside a pod).

A spec is the port's counterpart of ``PartitionSpec``: a tuple with, per
dim, a mesh-axis name, a tuple of names (one dim over several axes, in mesh
order) or None.  ``REPLICATED`` is ``()``.  ``placements`` turns a spec
into ``torch.distributed.tensor`` placements over a ``DeviceMesh``.

The train step (``training/steps.py``) applies these specs over ``model``
(tensor and expert parallelism): ``param_specs`` resolves every param of a
config from its logical (whole) layout, ``train_specs`` extends them to a
train state, ``shard_state`` keeps each rank's slice of every leaf (the
state is initialised whole on each rank and then sliced; an init at shard
size is FSDP's work, ROADMAP queue A item 9b-ii), and ``gather_leaf`` is
its inverse, one leaf at a time, so the peak stays one whole leaf.  The
pack is not sharded: every rank rebuilds it from its own mask shards.

One rule beside the resolver's: under ``kernel='block_sparse'`` a sparse
leaf whose shard would split a weight block (full danube's ``wk``/``wv``,
(2560, 640) on model = 2: 320 columns, 2.5 blocks of 128) is held whole on
every rank and runs replicated, its gradient summed over the model ranks
(``whole_leaves`` names them); so is an attention weight whose fused
(heads x head_dim) dim the resolver would cut inside a head (it tests the
fused width: danube SMOKE's two kv heads of 16 on model = 4).  That is what GSPMD does to a custom call's
operands in the reference (gather, run replicated, slice the gradient
back), without the per-step gather; a pack entry never spans two ranks.
FSDP (the ``data`` axis on ``embed``) is resolved but not applied
(9b-ii).
"""
from __future__ import annotations

import math

from ..core.masks import tree_map
from .mesh import axis_names, axis_sizes, dp_axes, dp_size

__all__ = ["REPLICATED", "resolve_spec", "param_shardings", "state_shardings",
           "batch_shardings", "cache_axes", "placements", "shard_batch", "param_specs",
           "train_specs", "whole_leaves", "spec_paths", "sharded_dims", "shard_index",
           "shard_state", "slice_leaf", "gather_leaf"]

REPLICATED = ()

# Logical axis -> candidate mesh axes, tried in order.
MODEL_AXES = ("experts", "heads", "kv_heads", "mlp", "moe_mlp", "vocab")
# resolution priority within one array (first match wins the mesh axis)
PRIORITY = [
    "experts",
    "heads",
    "kv_heads",
    "moe_mlp",
    "mlp",
    "vocab",
    "act_batch",  # batch first; KV-seq sharding picks up whatever is idle
    "act_kv_seq",  # decode KV fallback: flash-decoding style seq sharding
    "embed",  # FSDP (data axis), weights only
]


def _rules(mesh, *, fsdp: bool):
    dp = dp_axes(mesh)
    r: dict[str, tuple[tuple[str, ...], ...]] = {name: (("model",),) for name in MODEL_AXES}
    # decode KV-seq: grab every axis the (possibly tiny) batch left idle
    r["act_kv_seq"] = ((*dp, "model"), ("data", "model"), ("model",))
    r["act_batch"] = (dp,)
    if fsdp:
        r["embed"] = (("data",),)
    return r


def resolve_spec(axes, shape, mesh, *, fsdp: bool = False, min_fsdp_size: int = 2**16):
    """axes: a logical name (or None) per dim -> a spec of len(shape)."""
    rules = _rules(mesh, fsdp=fsdp)
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    spec: list = [None] * len(shape)
    used: set[str] = set()
    order = sorted(
        [i for i, a in enumerate(axes) if a in rules],
        key=lambda i: PRIORITY.index(axes[i]) if axes[i] in PRIORITY else 99,
    )
    size = math.prod(shape) if len(shape) else 0
    for i in order:
        if axes[i] == "embed" and size < min_fsdp_size:
            continue  # don't FSDP-shard tiny vectors (norm scales, biases)
        for cand in rules[axes[i]]:
            cand = tuple(c for c in cand if c in names)
            if not cand or any(c in used for c in cand):
                continue
            if shape[i] % math.prod(sizes[c] for c in cand) != 0:
                continue
            spec[i] = cand if len(cand) > 1 else cand[0]
            used.update(cand)
            break
    return tuple(spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def param_shardings(axes_tree, params, mesh, *, fsdp: bool = False):
    """Logical axes tree and the tree of params (or anything with
    ``.shape``) it mirrors -> tree of specs."""
    return tree_map(lambda _, axes, p: resolve_spec(axes, tuple(p.shape), mesh, fsdp=fsdp),
                    axes_tree, params, is_leaf=_is_axes)


def _replicated(tree):
    return tree_map(lambda _, t: None if t is None else REPLICATED, tree)


def state_shardings(state, axes_tree, mesh, *, fsdp: bool = False):
    """Spec tree of a whole train state (``training/steps.py``).

    Params take their resolved specs; masks, Top-KAST supersets, the
    optimizer's per-connection slots (momentum, m, v) and SNFS's
    ``dense_mom`` inherit them exactly (with ``fsdp``: ZeRO-style sharded
    optimizer state).  The step, seed, counters, Adam's count and the pack
    (host-built block indices, rebuilt on every rank from the masks) are
    replicated."""
    return _state_specs(state, param_shardings(axes_tree, state["params"], mesh,
                                               fsdp=fsdp))


def _state_specs(state, p_sh):
    """``state_shardings`` from the params' spec tree ``p_sh``."""
    like = lambda tree: tree_map(lambda _, m, s: None if m is None else s, tree, p_sh)
    out = {
        "step": REPLICATED,
        "seed": REPLICATED,
        "params": p_sh,
        "masks": like(state["masks"]),
        "opt": {k: p_sh if k in ("momentum", "m", "v") else REPLICATED
                for k in state["opt"]},
        "nonfinite_steps": REPLICATED,
    }
    if "bwd_masks" in state:
        out["bwd_masks"] = like(state["bwd_masks"])
    if "pack" in state:
        out["pack"] = _replicated(state["pack"])
    if "dense_mom" in state:
        out["dense_mom"] = p_sh
    return out


def batch_shardings(batch_tree, mesh):
    """Inputs: the batch dim over all data-parallel axes, where it divides
    (else replicated)."""
    dp, n_dp = dp_axes(mesh), dp_size(mesh)

    def f(_, x):
        spec = [None] * len(x.shape)
        if len(x.shape) and x.shape[0] % n_dp == 0:
            spec[0] = dp if len(dp) > 1 else dp[0]
        return tuple(spec)

    return tree_map(f, batch_tree)


# logical axes for cache leaves (mirrors models.model.init_caches)
KV_AXES = ("act_batch", "act_kv_seq", "kv_heads", "head_dim")
SSM_AXES = {"h": ("act_batch", "mlp", None), "conv": ("act_batch", None, "mlp")}
MLSTM_AXES = {
    "C": ("act_batch", "heads", None, None),
    "n": ("act_batch", "heads", None),
    "m": ("act_batch", "heads"),
}
SLSTM_AXES = {k: ("act_batch", "heads", None) for k in ("c", "n", "h", "m")}


def cache_axes(cfg):
    """Axes tree matching ``init_caches(cfg, ...)``."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.block_type == "xlstm":
            out.append({"slstm": dict(SLSTM_AXES)} if cfg.is_slstm(i)
                       else {"mlstm": dict(MLSTM_AXES)})
            continue
        c = {"kv": {"k": KV_AXES, "v": KV_AXES}}
        if cfg.block_type == "hymba":
            c["ssm"] = dict(SSM_AXES)
        out.append(c)
    return out


def placements(spec, mesh):
    """A spec -> ``torch.distributed.tensor`` placements over the
    ``DeviceMesh`` ``mesh``, one per mesh axis: ``Shard(i)`` where dim i
    names the axis, else ``Replicate()``.  A dim over several axes takes
    them in mesh order (the order DTensor shards in)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    dim_of = {}
    for i, entry in enumerate(spec):
        group = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        if list(group) != sorted(group, key=names.index):
            raise ValueError(f"spec {spec}: dim {i} takes {group} out of mesh order {names}")
        for name in group:
            dim_of[name] = i
    return [Shard(dim_of[n]) if n in dim_of else Replicate() for n in names]


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (every rank builds the same one
    from the seed): dim 0 cut into equal runs over the data-parallel axes,
    in the order of the ranks' coordinates on them, where
    ``batch_shardings`` shards it, else the whole tensor.  No
    communication."""
    dp, sizes = dp_axes(mesh), axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    n_dp, index = 1, 0
    for a in dp:  # the rank's position among the data-parallel ranks
        n_dp, index = n_dp * sizes[a], index * sizes[a] + coord[a]
    specs = batch_shardings(batch, mesh)

    def rows(k, v):
        if not specs[k] or specs[k][0] is None:
            return v
        n = v.shape[0] // n_dp
        return v[index * n:(index + 1) * n]

    return {k: rows(k, v) for k, v in batch.items()}


def _blocks_split(spec, shape, block, sizes) -> bool:
    """Does a shard by ``spec`` cut one of the trailing two dims inside a
    (bk, bn) weight block?"""
    nd = len(shape)
    for i, b in ((nd - 2, block[0]), (nd - 1, block[1])):
        if i >= 0 and spec[i] is not None:
            n = math.prod(sizes[a] for a in _axes_of(spec[i]))
            if (shape[i] // n) % b:
                return True
    return False


def _axes_of(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _heads_split(spec, shape, axes, head_dim, sizes) -> bool:
    """Does a shard by ``spec`` cut a fused (heads x head_dim) dim inside a
    head?  The resolver tests the fused width; a rank's attention runs
    whole heads."""
    for i, a in enumerate(axes):
        if a in ("heads", "kv_heads") and spec[i] is not None:
            n = math.prod(sizes[x] for x in _axes_of(spec[i]))
            if (shape[i] // head_dim) % n:
                return True
    return False


def _param_specs_and_whole(cfg, mesh):
    """(param specs, {leaf: why it is held whole}).  FSDP is resolved in
    ``state_shardings`` but not applied here (ROADMAP 9b-ii)."""
    from ..models.model import lm_layout

    params, axes, flags = lm_layout(cfg)
    specs = param_shardings(axes, params, mesh)
    sp, sizes, whole = cfg.sparse, axis_sizes(mesh), {}
    blocks = sp.kernel == "block_sparse" and sp.block_shape is not None

    def keep(name, spec, p, ax, f):
        shape = tuple(p.shape)
        if cfg.block_type == "transformer" and _heads_split(spec, shape, ax, cfg.head_dim,
                                                            sizes):
            whole[name] = "heads"
        elif blocks and f and _blocks_split(spec, shape, sp.block_shape, sizes):
            whole[name] = "blocks"
        else:
            return spec
        return (None,) * len(spec)

    return tree_map(keep, specs, params, axes, flags, is_leaf=_is_axes), whole


def param_specs(cfg, mesh):
    """The spec tree of ``init_lm(cfg)``'s params on ``mesh``: the
    resolver's, from the logical (whole) shapes, with the leaves
    ``whole_leaves`` names replicated."""
    return _param_specs_and_whole(cfg, mesh)[0]


def whole_leaves(cfg, mesh) -> dict[str, str]:
    """{leaf: "blocks" or "heads"} of the leaves the resolver would shard
    through a weight block or inside an attention head, which every rank
    holds whole instead and runs replicated (the module docstring)."""
    return _param_specs_and_whole(cfg, mesh)[1]


def train_specs(state, cfg, mesh):
    """``state_shardings`` of a train state of ``cfg`` with ``param_specs``
    (the state gives the structure only: it may be whole or sharded)."""
    return _state_specs(state, param_specs(cfg, mesh))


def spec_paths(specs) -> dict:
    """{path_name: spec} of a spec tree (the tuples are its leaves)."""
    out = {}
    tree_map(lambda n, s: out.__setitem__(n, s), specs, is_leaf=_is_axes)
    return out


def sharded_dims(spec) -> list[tuple[int, tuple[str, ...]]]:
    """[(dim, mesh axes)] of the dims a spec shards."""
    if not spec:
        return []
    return [(i, _axes_of(e)) for i, e in enumerate(spec) if e is not None]


def shard_index(mesh, axes) -> tuple[int, int]:
    """(number of shards, this rank's index) of a dim over mesh ``axes``."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    n, index = 1, 0
    for a in axes:
        n, index = n * sizes[a], index * sizes[a] + coord[a]
    return n, index


def slice_leaf(full, spec, mesh):
    """This rank's slice of a whole leaf by ``spec`` (an owned copy; a
    host int, or a leaf the spec replicates, comes back as it is)."""
    dims = sharded_dims(spec) if _is_tensor(full) else []
    if not dims:
        return full
    out = full
    for i, axes in dims:
        n, index = shard_index(mesh, axes)
        chunk = out.shape[i] // n
        out = out.narrow(i, index * chunk, chunk)
    return out.clone()


def gather_leaf(local, spec, mesh):
    """The whole leaf of which ``local`` is this rank's slice by ``spec``,
    on every rank of the mesh's groups along the sharded axes (collective:
    each of them calls it with its own slice).  One leaf at a time: the
    peak is one whole leaf.  A replicated leaf comes back as it is."""
    from ..models.tp import gather_dim

    dims = sharded_dims(spec) if _is_tensor(local) else []
    out = local
    for i, axes in dims:
        if len(axes) != 1:
            raise NotImplementedError(f"gather over several mesh axes {axes}")
        out = gather_dim(out, i, shard_index(mesh, axes)[0], mesh.get_group(axes[0]))
    return out


def _is_tensor(x) -> bool:
    import torch

    return torch.is_tensor(x)


def shard_state(state, specs, mesh):
    """Every leaf of ``state`` cut to this rank's slice by the spec tree
    ``specs`` (``train_specs``); leaves the specs replicate, host ints and
    None pass through (the same tensors, not copies)."""
    def cut(_, leaf, spec):
        return slice_leaf(leaf, spec, mesh) if leaf is not None else None

    return {k: tree_map(cut, v, specs[k]) if k in specs else v for k, v in state.items()}
