"""Fault-tolerant checkpointing of the port's train state.

Port of the JAX package's ``checkpoint/checkpoint.py``, with its on-disk
layout leaf for leaf, so either package restores the other's checkpoints:

- Crash-atomic: write into <dir>/tmp-<step> staging, fsync every file AND
  the directory entries, then rename to <dir>/step-<n> — a crash at any
  instant leaves either the complete old set or the complete new set, never
  a half-written step dir visible under the final name.  The manifest is
  written LAST (after the array blob is durable) and records the blob's
  byte size, so a torn write is detectable.
- Self-describing: one ``arrays.npz`` of flattened (``path_name`` -> array)
  leaves, ``/`` written as ``|``, plus ``manifest.json`` (``step``,
  ``none_leaves``, ``mask_shapes``, ``arrays_bytes``).
- Masks (leaves under ``masks/``) are bit-packed (``np.packbits``) under
  ``__packedmask__/``: 1 bit a connection on disk.
- keep_last_k garbage collection (also sweeps stray tmp-* staging dirs left
  by crashes); torn or unreadable checkpoints are skipped on restore
  (``latest_step``/``restore`` fall back to the newest VALID one).
- Async: ``save(..., background=True)`` takes an OWNED host copy of every
  leaf before it returns, then writes off-thread; the train step updates
  params and optimizer state in place, so the copy must not alias them.

Leaves the port holds differently from the reference, written as the
reference writes them:

- bf16 tensors as their 2-byte bits (numpy has no bfloat16: the reference's
  ``np.savez`` of an ``ml_dtypes`` array stores the same ``|V2`` bits); on
  restore a 2-byte leaf is viewed as the template's bf16.
- host ints (``step``, ``seed``, a pack entry's ``nnz``/``nkb``/``bnnz``)
  as 0-d int32 arrays; restored as ints where the template has an int.

``restore`` puts each leaf on the device and in the dtype of the template's
(``like``'s) leaf.

Sharded states (tensor parallelism over a mesh's ``model`` axis,
``launch/sharding.py``): ``save(specs=, mesh=)`` gathers each sharded leaf
whole, one at a time (every rank takes part in the gather; rank 0 alone
writes), so the files of a sharded run hold the logical arrays in a
one-process run's layout, and both cross-package restores still work.  The
pack is derived state and per rank: a sharded save writes none (restore
takes the template's, and the caller re-packs).  ``restore(specs=,
mesh=)``, the reference's ``shardings=``, cuts each rank's slice from the
logical array, so a checkpoint restores onto any (data, model) mesh.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..core.masks import flat_index, tree_map

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_MASK_PREFIX = "__packedmask__/"


def _flatten(tree) -> dict[str, Any]:
    """{path_name: leaf} in the reference's flatten order, None leaves kept."""
    flat: dict[str, Any] = {}
    tree_map(lambda name, v: flat.__setitem__(name, v), tree)
    order = flat_index(tree)
    return {n: flat[n] for n in sorted(flat, key=order.__getitem__)}


def _host(v) -> np.ndarray:
    """An owned host numpy copy of one leaf (never a view of ``v``)."""
    if torch.is_tensor(v):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    return np.array(v)


def save(state, ckpt_dir, step: int, *, keep_last_k: int = 3,
         background: bool = False, timings: Optional[dict] = None, specs=None,
         mesh=None):
    """Write ``state`` as ``<ckpt_dir>/step-<step>``; with ``background``
    the host snapshot is taken here and the write runs on a thread, which is
    returned.  ``timings``, if given, receives ``snapshot_s`` and (when the
    write ends) ``write_s``.  ``specs``/``mesh``: the state is this rank's
    shards by the spec tree ``specs`` (``train_specs``); every rank of the
    mesh calls this, rank 0 alone writes (the others return None)."""
    from ..launch.sharding import gather_leaf, spec_paths

    sharded = specs is not None and mesh is not None
    writer = mesh is None or torch.distributed.get_rank() == 0
    spec_of = spec_paths(specs) if sharded else {}
    ckpt_dir = pathlib.Path(ckpt_dir)
    if writer:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    host: dict[str, np.ndarray] = {}
    meta = {"step": int(step), "none_leaves": [], "mask_shapes": {}}
    for name, v in _flatten(state).items():
        if sharded and name.startswith("pack/"):
            continue  # per rank, derived: restore re-packs
        if v is None:
            meta["none_leaves"].append(name)
            continue
        if name in spec_of:
            v = gather_leaf(v, spec_of[name], mesh)
        if not writer:
            continue
        arr = _host(v)
        if arr.dtype == np.bool_ and name.startswith("masks/"):
            meta["mask_shapes"][name] = list(arr.shape)
            host[_MASK_PREFIX + name] = np.packbits(arr.reshape(-1))
        else:
            host[name] = arr
    if timings is not None:
        timings["snapshot_s"] = time.perf_counter() - t0
    if not writer:
        return None

    def _write():
        t1 = time.perf_counter()
        tmp = ckpt_dir / f"tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **{k.replace("/", "|"): v for k, v in host.items()})
        _fsync_file(tmp / "arrays.npz")
        # manifest goes LAST, after the blob is durable, carrying the blob's
        # byte size: a manifest that exists and matches implies a complete
        # array file (restore/_valid check this)
        meta["arrays_bytes"] = (tmp / "arrays.npz").stat().st_size
        (tmp / "manifest.json").write_text(json.dumps(meta))
        _fsync_file(tmp / "manifest.json")
        _fsync_dir(tmp)
        final = ckpt_dir / f"step-{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _fsync_dir(ckpt_dir)  # make the rename itself durable
        _gc(ckpt_dir, keep_last_k)
        if timings is not None:
            timings["write_s"] = time.perf_counter() - t1

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _fsync_file(p: pathlib.Path) -> None:
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(p: pathlib.Path) -> None:
    try:
        fd = os.open(p, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return  # filesystems without directory fds: best-effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(ckpt_dir.glob("step-*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    for stray in ckpt_dir.glob("tmp-*"):  # staging dirs orphaned by a crash
        shutil.rmtree(stray, ignore_errors=True)


def _valid(d: pathlib.Path) -> bool:
    """True iff ``d`` holds a COMPLETE checkpoint: the manifest parses and
    the array blob exists with the byte size the manifest recorded
    (manifests without the size field fall back to existence)."""
    man, blob = d / "manifest.json", d / "arrays.npz"
    if not (man.exists() and blob.exists()):
        return False
    try:
        meta = json.loads(man.read_text())
    except (json.JSONDecodeError, OSError):
        return False
    want = meta.get("arrays_bytes")
    return want is None or blob.stat().st_size == want


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    for d in sorted(ckpt_dir.glob("step-*"), reverse=True):
        if _valid(d):
            return int(d.name.split("-")[1])
    return None


def restore(like, ckpt_dir, *, step: Optional[int] = None, specs=None, mesh=None):
    """Rebuild a state shaped like ``like`` from disk -> (state, step).

    ``specs``/``mesh`` (the reference's ``shardings=``): ``like`` is this
    rank's shards by the spec tree ``specs``, and each leaf is cut from
    the logical array on disk (a checkpoint of any mesh, or of one
    process).

    With ``step=None`` this walks step dirs NEWEST-FIRST and skips any that
    are torn or unreadable (the size check, then zip/json decode errors at
    load time), so a crash during the latest save costs one checkpoint
    interval, never the run.  An explicit ``step`` is a caller decision:
    errors propagate.  A leaf of ``like`` missing from the file raises
    ``KeyError``, except ``pack/...`` (derived state: callers re-pack after
    restoring) and ``nonfinite_steps`` (a counter), which take the
    template's leaf.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    cut = None
    if specs is not None and mesh is not None:
        from ..launch.sharding import shard_index, sharded_dims, spec_paths

        spec_of = spec_paths(specs)

        def cut(name, arr):  # this rank's slice of a logical array
            where = [slice(None)] * arr.ndim
            for i, axes in sharded_dims(spec_of.get(name, ())):
                n, index = shard_index(mesh, axes)
                c = arr.shape[i] // n
                where[i] = slice(index * c, (index + 1) * c)
            return arr[tuple(where)]
    if step is not None:
        return _restore_dir(like, ckpt_dir / f"step-{step:010d}", cut), step
    if ckpt_dir.exists():
        for d in sorted(ckpt_dir.glob("step-*"), reverse=True):
            if not _valid(d):
                continue
            try:
                got = _restore_dir(like, d, cut)
            except (zipfile.BadZipFile, json.JSONDecodeError, OSError, ValueError):
                continue  # torn past the size check (e.g. a corrupt zip member)
            return got, int(d.name.split("-")[1])
    raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")


def _leaf(arr: np.ndarray, like):
    """One stored array as the template leaf's kind (a host int or a
    tensor), dtype and device."""
    if isinstance(like, int):
        return int(arr)
    arr = np.asarray(arr, order="C")  # (keeps 0-d arrays 0-d)
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "Vui":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device)


def _restore_dir(like, d: pathlib.Path, cut=None):
    meta = json.loads((d / "manifest.json").read_text())
    arrays: dict[str, np.ndarray] = {}
    with np.load(d / "arrays.npz") as data:
        for k in data.files:
            name = k.replace("|", "/")
            if name.startswith(_MASK_PREFIX):
                real = name[len(_MASK_PREFIX):]
                shape = meta["mask_shapes"][real]
                n = int(np.prod(shape))
                arrays[real] = np.unpackbits(data[k])[:n].reshape(shape).astype(bool)
            else:
                arrays[name] = data[k]

    def leaf(name, t):
        if t is None:
            return None
        if cut is not None and name.startswith("pack/"):
            return t  # this rank's own pack: the caller re-packs
        arr = arrays.get(name)
        if arr is None:
            if name.startswith("pack/") or name == "nonfinite_steps":
                # derived state (callers refresh_pack after restoring) and a
                # telemetry counter that restarts at the template value
                return t
            raise KeyError(f"checkpoint {d} is missing leaf {name!r}")
        if cut is not None:
            arr = cut(name, arr)
        return _leaf(arr, t)

    return tree_map(leaf, like)


class Checkpointer:
    """Periodic async save + restart-aware restore.

    ``timings`` holds the last save's ``snapshot_s`` and ``write_s`` and
    the last ``wait``'s ``wait_s``."""

    def __init__(self, ckpt_dir, every: int = 500, keep_last_k: int = 3, *, specs=None,
                 mesh=None):
        self.dir = pathlib.Path(ckpt_dir)
        self.every = every
        self.keep = keep_last_k
        self.specs, self.mesh = specs, mesh
        self.timings: dict = {}
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, state, step: int, *, force: bool = False):
        """Every rank of a mesh calls this (a sharded save gathers); rank 0
        writes."""
        if not force and (self.every <= 0 or step % self.every != 0):
            return
        self.wait()
        self.timings = {}
        self._thread = save(state, self.dir, step, keep_last_k=self.keep,
                            background=True, timings=self.timings, specs=self.specs,
                            mesh=self.mesh)

    def wait(self):
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self.timings["wait_s"] = time.perf_counter() - t0

    def restore_or_none(self, like):
        try:
            return restore(like, self.dir, specs=self.specs, mesh=self.mesh)
        except FileNotFoundError:
            return None, None
