"""Meshes of the port: ``torch.distributed`` device meshes with the
reference's axis names.

Single pod: (data=16, model=16) = 256 cards.  Multi-pod: (pod=2, data=16,
model=16) = 512; the batch is also sharded over the slow inter-pod axis,
while tensor parallelism and FSDP stay inside a pod.

A mesh is built over a LIVE process group: the caller runs
``torch.distributed.init_process_group`` with its address, world size and
rank first (nothing on the card's machine announces a cluster), and a
mesh whose size is not the world's raises.  There is no quiet
single-process fallback.  Functions, never module-level constants, so
importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "axis_names", "axis_sizes",
           "dp_axes", "dp_size", "dp_group"]


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs a live process group: call "
            "torch.distributed.init_process_group (address, world size, rank) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh of cards, or with ``multi_pod``
    the (2, 16, 16) ("pod", "data", "model") one, over 256 / 512 ranks."""
    if multi_pod:
        return _mesh("cuda", (2, 16, 16), ("pod", "data", "model"))
    return _mesh("cuda", (16, 16), ("data", "model"))


def make_local_mesh(n_data: int = 1, n_model: int = 1, *, device_type: str):
    """A small ("data", "model") mesh over the live process group (tests,
    one host)."""
    return _mesh(device_type, (n_data, n_model), ("data", "model"))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of any mesh object with
    ``axis_names`` (the resolver's fakes)."""
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.mesh_dim_names if names is None else names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh object whose
    ``shape`` is that dict already."""
    shape = mesh.shape
    return dict(shape) if isinstance(shape, dict) else dict(zip(axis_names(mesh), shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """Mesh axes carrying the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def dp_size(mesh) -> int:
    """Ranks over which the batch is split (the product of ``dp_axes``)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def dp_group(mesh):
    """The process group of the data-parallel ranks: the ``data`` axis's,
    or, over ``pod`` and ``data`` with no other axis wider than 1, the
    whole mesh's (which spans the world: ``_mesh`` checks it)."""
    dp = dp_axes(mesh)
    if len(dp) == 1:
        return mesh.get_group(dp[0])
    if dp_size(mesh) != mesh.size():
        raise NotImplementedError(
            "data parallelism over several dp axes beside a model axis wider than 1 "
            "is ROADMAP queue A item 9b")
    return dist.group.WORLD
