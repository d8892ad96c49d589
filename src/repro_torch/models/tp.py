"""Tensor parallelism over the mesh's ``model`` axis: Megatron's two
autograd Functions, the vocab-parallel pieces, and the gather of one
sharded leaf.

  copy_to_model      identity forward, all-reduce SUM over the model
                     group backward: the input of a column-parallel region
                     (each rank's local output columns give it a partial
                     input gradient), and a replicated weight read inside
                     such a region (kv projections whose heads do not
                     divide the axis, the qk-norm scales, the MoE gates);
  reduce_from_model  all-reduce SUM forward, identity backward: the output
                     of a row-parallel region (each rank's local input
                     rows give a partial product).

Sums run in f32: a bf16 tensor is upcast for the all-reduce and cast back,
so a row-parallel partial is rounded once more, not once a rank.

The model code reads the group from ``model_parallel(group, size, rank)``,
a context the train step opens around its forward and backward (it
resolves the mesh's model axis: ``launch/mesh.py``).  It is a module
global, not a thread-local: autograd runs a CUDA backward (and a remat
region's recompute) on its own device thread.  The Functions keep the
group they were built with, so their backward needs no context.  Outside
the context, or on a model axis of 1, every op is the identity and
launches nothing: the one-process path runs exactly as before.

Whether a leaf is sharded is read from its local shape against the
config's global width (``shards``): the shapes are the resolver's specs
as ``launch/sharding.py::shard_state`` applied them (a dim is cut over
``model`` only where the axis divides it, and a leaf whose shard would
split a weight block or a head is held whole), so the model reads the
resolved specs without a second copy of the rule.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = [
    "model_parallel",
    "data_parallel",
    "data_shard",
    "mean_over_data",
    "active",
    "size",
    "rank",
    "group",
    "shards",
    "local_range",
    "copy_to_model",
    "reduce_from_model",
    "max_over_model",
    "all_reduce_sum",
    "gather_dim",
]

_CTX = {"group": None, "size": 1, "rank": 0, "data": None}


@contextlib.contextmanager
def model_parallel(group, size: int, rank: int):
    """Run the body with ``group`` (``size`` ranks, this one ``rank``) as
    the tensor-parallel group; a no-op where ``size`` is 1."""
    prev = dict(_CTX)
    if size > 1:
        _CTX.update(group=group, size=size, rank=rank)
    try:
        yield
    finally:
        _CTX.update(prev)


@contextlib.contextmanager
def data_parallel(cut):
    """Run the body on this rank's rows of a batch cut over data-parallel
    ranks, ``cut`` = (group, ranks, this rank's index), or None where the
    rows are the whole batch: the MoE then routes as the whole batch does
    (``data_shard``)."""
    prev = _CTX["data"]
    _CTX["data"] = cut
    try:
        yield
    finally:
        _CTX["data"] = prev


def data_shard():
    """(group, ranks, this rank's index) of the data-parallel cut of the
    rows in hand, or None when they are the whole batch."""
    return _CTX["data"]


def active() -> bool:
    return _CTX["group"] is not None


def size() -> int:
    return _CTX["size"]


def rank() -> int:
    return _CTX["rank"]


def group():
    return _CTX["group"]


def shards(local: int, full: int) -> bool:
    """Is a dim of global width ``full`` held as this rank's shard (its
    local width ``local`` the narrower)?  False outside the context."""
    if not active() or local == full:
        return False
    if local * size() != full:
        raise ValueError(f"a dim of width {local} is neither the whole {full} nor its "
                         f"1/{size()} shard")
    return True


def local_range(full: int) -> tuple[int, int]:
    """[lo, hi) of this rank's run of a dim of width ``full`` sharded over
    the model axis."""
    n = full // size()
    return rank() * n, (rank() + 1) * n


def all_reduce_sum(t, grp, *, inplace: bool = False):
    """SUM over ``grp`` in f32 (a narrower float upcast and cast back; a
    bool summed as uint8, so at most one rank may hold a True); a new
    tensor, or ``t`` itself with ``inplace`` where its dtype reduces as it
    is."""
    wide = {torch.bfloat16: torch.float32, torch.float16: torch.float32,
            torch.bool: torch.uint8}.get(t.dtype, t.dtype)
    if inplace and wide == t.dtype and t.is_contiguous():
        buf = t
    else:
        buf = t.to(wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, group=grp)
    return buf if buf.dtype == t.dtype else buf.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.grp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return all_reduce_sum(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x):
    """Identity forward; the gradient summed over the model ranks."""
    return x if not active() else _CopyToModel.apply(x, group())


def reduce_from_model(x):
    """The sum over the model ranks; the gradient passes as it is."""
    return x if not active() else _ReduceFromModel.apply(x, group())


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, n):
        return all_reduce_sum(x, grp) / n

    @staticmethod
    def backward(ctx, g):
        # the train step averages every rank's gradient over the data
        # ranks afterwards, which takes the mean's 1/n
        return g, None, None


def mean_over_data(x):
    """The mean over the data ranks of ``data_shard`` (x itself without
    one); the gradient passes as it is (see ``_MeanOverData``)."""
    d = data_shard()
    return x if d is None else _MeanOverData.apply(x, d[0], d[1])


def max_over_model(x):
    """The elementwise max over the model ranks, no gradient (the
    vocab-parallel loss's shift)."""
    if not active():
        return x.detach()
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group())
    return out


def gather_dim(local, dim: int, n: int, grp):
    """The whole tensor of which ``local`` is one of ``n`` equal shards
    along ``dim``, in rank order, on every rank of ``grp``: an all-gather
    of the shards with ``dim`` moved to the front, so each lands
    contiguous (gloo gathers CUDA tensors through the host as it
    all-reduces them).  No gradient."""
    send = local.movedim(dim, 0).contiguous()
    buf = send.new_empty((n * send.shape[0], *send.shape[1:]))
    dist.all_gather(list(buf.chunk(n)), send, group=grp)
    return buf.movedim(0, dim).contiguous()
