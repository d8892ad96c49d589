"""PackState: the host-packed block topology the block-sparse kernel runs on.

Port of the JAX package's ``core/pack.py`` for serving.  The block-sparse
forward kernel (``kernels/block_sparse_matmul.py``) is driven by a CSC
packing of a layer's block-activity mask: per N-block column, the ids of its
active K-blocks (``idx (N/bn, width) int32``) and how many are real
(``cnt (N/bn,)``).  ``width`` is the largest count (tight), so a kernel's
loop runs over the true active blocks.  The packing is computed once on the
host from concrete masks and reused by every prefill and decode step.

Entry layout (one per packable 2-D mask leaf under ``attn``/``mlp``, ``None``
elsewhere), the same keys as the reference:

  {"idx":  (N/bn, width) int32 tensor,   # CSC: forward kernel
   "cnt":  (N/bn,) int32 tensor,
   "ridx": (K/bk, row_width) int32,      # CSR: the dgrad kernel's view
   "rcnt": (K/bk,) int32,                #   (kept for parity and checks)
   "nnz":  int,                          # total active blocks
   "nkb":  int}                          # K/bk

The reference's Top-KAST superset view (``bidx``/``bcnt``/``bnnz``) feeds
only the wgrad kernel; serving never differentiates, so the port leaves it
out.  Grouped (3-D) banks belong to model families the port does not run
yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .masks import block_mask_of, tree_map

__all__ = [
    "PackIntegrityError",
    "build_pack_state",
    "is_pack_entry",
    "pack_entry",
    "pack_entries",
    "pack_np",
    "slack_width",
    "validate_pack",
]

# Param subtrees whose weights go through layers.linear (transformer family).
DISPATCHED_SUBTREES = ("attn", "mlp")


class PackIntegrityError(ValueError):
    """A PackState entry violates its CSC/CSR invariants; the kernel would
    otherwise run the WRONG topology with no error."""


def is_pack_entry(x) -> bool:
    return x is None or (isinstance(x, dict) and "idx" in x and "cnt" in x)


def _dispatched(name: str) -> bool:
    return any(part in DISPATCHED_SUBTREES for part in name.split("/"))


def pack_np(bm, max_count: Optional[int] = None):
    """Per-COLUMN active row ids of a bool matrix (the reference's
    ``block_sparse_matmul.py::_pack_np``).

    bm: (R, C) bool -> (idx (C, max_count) int32, counts (C,) int32), ids
    ascending, slots beyond a column's count 0.  A ``max_count`` below some
    column's count raises: truncating would drop active blocks silently.
    """
    bm = np.asarray(bm, bool)
    counts = bm.sum(axis=0).astype(np.int32)
    if max_count is None:
        max_count = max(int(counts.max(initial=0)), 1)
    elif int(counts.max(initial=0)) > max_count:
        raise ValueError(
            f"pack_np: max_count={max_count} < max active blocks per column "
            f"({int(counts.max())}); truncating would drop active blocks"
        )
    order = np.argsort(~bm, axis=0, kind="stable")
    idx = order[:max_count].T.astype(np.int32)
    idx = np.where(np.arange(max_count)[None, :] < counts[:, None], idx, 0)
    return idx, counts


def slack_width(width: int, worst: int, slack: float) -> int:
    """Round a packed width UP to the next multiple of ``ceil(slack*worst)``,
    capped at ``worst`` (``SparseConfig.pack_width_slack``; 0 keeps it)."""
    if slack <= 0.0 or width >= worst:
        return min(width, worst)
    step = max(int(np.ceil(slack * worst)), 1)
    return min(-(-width // step) * step, worst)


def pack_entry(mask, block_shape, *, slack: float = 0.0, name: str = "?",
               device=None) -> dict:
    """Pack ONE 2-D mask leaf into a PackState entry (CSC + CSR views).

    Raises when the layer has no active block at all: the kernel would
    output zeros for the whole layer.  Single all-zero COLUMNS are fine (the
    kernel writes zeros for them).
    """
    bm = block_mask_of(mask, block_shape)
    if isinstance(bm, torch.Tensor):
        device = bm.device if device is None else device
        bm = bm.cpu().numpy()
    bm = np.asarray(bm, bool)
    if bm.ndim != 2:
        raise NotImplementedError(
            f"PackState: layer {name!r} has a {bm.ndim}-D block mask; grouped "
            "banks are not ported yet"
        )
    nkb, nnb = bm.shape
    total = int(bm.sum())
    if total == 0:
        raise ValueError(
            f"PackState: layer {name!r} has ZERO active blocks — the "
            "block-sparse kernel would output all-zeros for it"
        )
    width = slack_width(max(int(bm.sum(axis=0).max()), 1), nkb, slack)
    row_width = slack_width(max(int(bm.sum(axis=1).max()), 1), nnb, slack)
    idx, cnt = pack_np(bm, width)
    ridx, rcnt = pack_np(bm.T, row_width)
    t = lambda a: torch.from_numpy(a).to(device or "cpu")
    return {"idx": t(idx), "cnt": t(cnt), "ridx": t(ridx), "rcnt": t(rcnt),
            "nnz": total, "nkb": nkb}


def build_pack_state(masks, block_shape, *, slack: float = 0.0, device=None):
    """Mask tree -> PackState tree (same structure; entry or None leaves).

    Entries live on ``device`` (default: the mask's device), where the
    kernels read them.
    """
    bk, bn = block_shape

    def pack(name, m):
        if (m is None or m.ndim != 2 or m.shape[0] % bk or m.shape[1] % bn
                or not _dispatched(name)):
            return None
        return pack_entry(m, block_shape, slack=slack, name=name,
                          device=device)

    return tree_map(pack, masks)


def pack_entries(pack, prefix=""):
    """Yield (path_name, entry) for every non-None entry of a pack tree."""
    if is_pack_entry(pack):
        if pack is not None:
            yield prefix, pack
    elif isinstance(pack, dict):
        for k in sorted(pack):
            yield from pack_entries(pack[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(pack, (list, tuple)):
        for i, v in enumerate(pack):
            yield from pack_entries(v, f"{prefix}/{i}" if prefix else str(i))


def validate_pack(pack, *, where: str = "pack") -> int:
    """Host-side CSC/CSR integrity check over every PackState entry.

    Per entry: ``cnt`` matches ``idx`` minus its width dim (same for
    ``rcnt``/``ridx``), the CSR has ``nkb`` rows, counts lie in
    ``[0, width]``, every live index lies inside the block grid, and
    ``sum(cnt) == nnz == sum(rcnt)``.  Raises ``PackIntegrityError`` naming
    the layer; returns the number of entries checked.
    """
    if pack is None:
        return 0
    checked = 0
    for path, e in pack_entries(pack):
        name = f"{where}:{path}"

        def fail(msg):
            raise PackIntegrityError(
                f"PackState integrity violation at {name}: {msg} — the "
                "block-sparse kernel would execute a corrupted topology"
            )

        for k in ("idx", "cnt", "ridx", "rcnt", "nnz", "nkb"):
            if k not in e:
                fail(f"entry is missing field {k!r}")
        idx, cnt, ridx, rcnt = (
            torch.as_tensor(e[k]).cpu().numpy()
            for k in ("idx", "cnt", "ridx", "rcnt")
        )
        nnz, nkb = int(e["nnz"]), int(e["nkb"])
        if idx.shape[:-1] != cnt.shape:
            fail(f"idx {idx.shape} does not extend cnt {cnt.shape}")
        if ridx.shape[:-1] != rcnt.shape:
            fail(f"ridx {ridx.shape} does not extend rcnt {rcnt.shape}")
        if ridx.shape[-2] != nkb:
            fail(f"CSR has {ridx.shape[-2]} rows, expected nkb={nkb}")
        width, row_width = idx.shape[-1], ridx.shape[-1]
        nnb = cnt.shape[-1]
        if cnt.size and (cnt.min() < 0 or cnt.max() > width):
            fail(f"cnt out of range [0, width={width}] (max {int(cnt.max())})")
        if rcnt.size and (rcnt.min() < 0 or rcnt.max() > row_width):
            fail(f"rcnt out of range [0, row_width={row_width}] "
                 f"(max {int(rcnt.max())})")
        live = np.arange(width) < cnt[..., None]
        if np.any(live & ((idx < 0) | (idx >= nkb))):
            fail(f"live CSC index outside the K-block grid [0, {nkb})")
        rlive = np.arange(row_width) < rcnt[..., None]
        if np.any(rlive & ((ridx < 0) | (ridx >= nnb))):
            fail(f"live CSR index outside the N-block grid [0, {nnb})")
        csum, rsum = int(cnt.sum()), int(rcnt.sum())
        if csum != nnz or rsum != nnz:
            fail(f"nnz inconsistency: sum(cnt)={csum}, sum(rcnt)={rsum}, "
                 f"recorded nnz={nnz}")
        checked += 1
    return checked
