"""PackState: the host-packed block topology the block-sparse kernels run on.

Port of the JAX package's ``core/pack.py``.  The block-sparse kernels
(``kernels/block_sparse_matmul.py``) are driven by packings of a layer's
block-activity mask: per N-block column, the ids of its active K-blocks
(CSC ``idx (N/bn, width) int32`` and ``cnt (N/bn,)``: the forward K1) and
per K-block row the ids of its active N-blocks (CSR ``ridx``/``rcnt``: the
dgrad K2).  Widths are the largest counts (tight), so a kernel's loop runs
over the true active blocks.  Packs are computed on the host from concrete
masks: once for serving, and after every topology update in training
(``refresh_pack_state``: widths never shrink).

Entry layout (one per packable mask leaf under ``attn``/``mlp``/``ssm``/
``moe``/``mlstm``/``slstm``, ``None`` elsewhere), the same keys as the reference:

  {"idx":  (N/bn, width) int32 tensor,   # CSC: forward (K1)
   "cnt":  (N/bn,) int32 tensor,
   "ridx": (K/bk, row_width) int32,      # CSR: dgrad (K2)
   "rcnt": (K/bk,) int32,
   "nnz":  int,                          # total active blocks
   "nkb":  int,                          # K/bk
   # with backward masks (Top-KAST superset B ⊇ A, core/rigl.py):
   "bidx": (N/bn, bwidth) int32,         # superset CSC: wgrad (K3)
   "bcnt": (N/bn,) int32,
   "bnnz": int}

Grouped weight banks (3-D masks: the MoE experts' (E, d, ff), sLSTM's
recurrent bank (nh, hd, 4 hd), a bare leaf ``.../slstm/r``) carry the
same entry with a leading group dim on idx/cnt/ridx/rcnt (and bidx/bcnt):
per-group CSC/CSR at ONE shared width over all groups, so one grouped
kernel launch (K4) covers the bank.  A group with no active block (a dead
expert) is legal: its counts are all zero and the kernel writes zeros for
it; only an all-zero BANK raises.

Under kernel='masked' the masks need no packing: the Top-KAST superset
rides along as the carrier ``{"bwd_mask": bool (K, N)}`` per dispatched
leaf (``build_bwd_carrier``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .masks import block_mask_of, tree_map

__all__ = [
    "PackIntegrityError",
    "build_bwd_carrier",
    "build_pack_state",
    "is_pack_entry",
    "pack_entry",
    "pack_entries",
    "pack_mismatch",
    "pack_group_mask",
    "pack_group_mask_rows",
    "pack_np",
    "pack_stats",
    "publish_pack_gauges",
    "refresh_pack_state",
    "slack_width",
    "validate_pack",
]

# Param subtrees whose weights go through layers.linear / grouped_linear:
# attention, the MLP, hymba's SSM projections (``in_proj``, ``out_proj``;
# its scan weights are dense and carry no mask), the MoE banks and shared
# experts, and the xLSTM blocks (sLSTM's recurrent bank ``r`` is a
# grouped entry).
DISPATCHED_SUBTREES = ("attn", "mlp", "ssm", "slstm", "mlstm", "moe")


class PackIntegrityError(ValueError):
    """A PackState entry violates its CSC/CSR invariants; the kernel would
    otherwise run the WRONG topology with no error."""


def is_pack_entry(x) -> bool:
    """Leaf predicate of pack trees: None, a block-sparse entry, the masked
    kernel's superset carrier, or a fused-epilogue entry (``"mom"``)."""
    return x is None or (isinstance(x, dict) and (
        ("idx" in x and "cnt" in x) or "bwd_mask" in x or "mom" in x))


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


def pack_group_mask(block_masks, max_count: Optional[int] = None):
    """Stacked per-group CSC pack of a (G, K/bk, N/bn) bool block-mask stack
    (the reference's ``block_sparse_matmul.py::pack_group_mask``).

    Returns (idx (G, N/bn, width), cnt (G, N/bn)) int32 numpy arrays at ONE
    shared ``width`` (``max_count``, or the largest active-K count over all
    groups and columns) so a single grouped kernel grid covers every group.
    A group with no active block is legal (all its counts are zero); a
    ``max_count`` below some column's count raises (``pack_np``).
    """
    bms = np.asarray(block_masks, bool)
    if bms.ndim != 3:
        raise ValueError(f"pack_group_mask: expected a (G, K/bk, N/bn) stack, "
                         f"got shape {bms.shape}")
    if max_count is None:
        max_count = max(int(bms.sum(axis=1).max(initial=0)), 1)
    packed = [pack_np(b, max_count) for b in bms]
    return (np.stack([i for i, _ in packed]).astype(np.int32),
            np.stack([c for _, c in packed]).astype(np.int32))


def pack_group_mask_rows(block_masks, max_count: Optional[int] = None):
    """Stacked per-group CSR pack (the grouped dgrad's view): per K-block
    row of each group, its active N-block ids."""
    return pack_group_mask(np.asarray(block_masks).transpose(0, 2, 1), max_count)


def slack_width(width: int, worst: int, slack: float) -> int:
    """Round a packed width UP to the next multiple of ``ceil(slack*worst)``,
    capped at ``worst`` (``SparseConfig.pack_width_slack``; 0 keeps it)."""
    if slack <= 0.0 or width >= worst:
        return min(width, worst)
    step = max(int(np.ceil(slack * worst)), 1)
    return min(-(-width // step) * step, worst)


def _block_np(mask, block_shape):
    bm = block_mask_of(mask, block_shape)
    if isinstance(bm, torch.Tensor):
        bm = bm.cpu().numpy()
    return np.asarray(bm, bool)


def pack_entry(mask, block_shape, *, min_width: int = 0, min_row_width: int = 0,
               slack: float = 0.0, name: str = "?", device=None, bwd_mask=None,
               min_bwd_width: int = 0) -> dict:
    """Pack ONE mask leaf into a PackState entry (CSC + CSR views, and the
    superset CSC of ``bwd_mask`` when given).

    2-D masks pack per layer; 3-D masks (grouped weight banks) pack PER
    GROUP over the trailing two dims, stacked at one shared width
    (``idx (G, N/bn, width)`` etc.: ``pack_group_mask``).  Raises when the
    layer (the whole bank) has no active block at all (the kernel would
    output zeros for all of it), and when ``bwd_mask`` does not contain the
    forward mask (wgrad would zero forward-active blocks).  Single all-zero
    COLUMNS are fine (the kernel writes zeros for them), and so is an
    all-zero GROUP: a dead expert outputs zeros.  ``min_*`` floors keep
    refreshed widths from shrinking.
    """
    if device is None and isinstance(mask, torch.Tensor):
        device = mask.device
    bm = _block_np(mask, block_shape)
    if bm.ndim not in (2, 3):
        raise ValueError(f"PackState: layer {name!r} has a {bm.ndim}-D block mask")
    grouped = bm.ndim == 3
    nkb, nnb = bm.shape[-2:]
    total = int(bm.sum())
    if total == 0:
        raise ValueError(
            f"PackState: layer {name!r} has ZERO active blocks — the "
            "block-sparse kernel would output all-zeros for it"
        )
    csc, csr = ((pack_group_mask, pack_group_mask_rows) if grouped else
                (pack_np, lambda b, w: pack_np(b.T, w)))
    width = slack_width(max(int(bm.sum(axis=-2).max()), 1, min_width), nkb, slack)
    row_width = slack_width(max(int(bm.sum(axis=-1).max()), 1, min_row_width),
                            nnb, slack)
    idx, cnt = csc(bm, width)
    ridx, rcnt = csr(bm, row_width)
    t = lambda a: torch.from_numpy(a).to(device or "cpu")
    entry = {"idx": t(idx), "cnt": t(cnt), "ridx": t(ridx), "rcnt": t(rcnt),
             "nnz": total, "nkb": nkb}
    if bwd_mask is not None:
        bbm = _block_np(bwd_mask, block_shape)
        if np.any(bm & ~bbm):
            raise PackIntegrityError(
                f"PackState: layer {name!r} backward superset does not contain "
                "its forward topology — wgrad would silently zero "
                "forward-active blocks"
            )
        bwidth = slack_width(max(int(bbm.sum(axis=-2).max()), 1, min_bwd_width),
                             nkb, slack)
        bidx, bcnt = csc(bbm, bwidth)
        entry |= {"bidx": t(bidx), "bcnt": t(bcnt), "bnnz": int(bbm.sum())}
    return entry


def build_pack_state(masks, block_shape, *, slack: float = 0.0, device=None,
                     prev=None, bwd_masks=None):
    """Mask tree -> PackState tree (same structure; entry or None leaves).

    Entries live on ``device`` (default: the mask's device), where the
    kernels read them.  ``prev``: a previous PackState whose widths are
    floors (never shrink).  ``bwd_masks``: Top-KAST supersets mirroring
    ``masks``; entries then carry the superset CSC (``bidx``/``bcnt``).
    """
    bk, bn = block_shape

    def pack(name, m, bw, pe):
        if (m is None or m.ndim not in (2, 3) or m.shape[-2] % bk
                or m.shape[-1] % bn or not _dispatched(name)):
            return None
        floor = lambda k: int(pe[k].shape[-1]) if pe is not None and k in pe else 0
        return pack_entry(m, block_shape, slack=slack, name=name, device=device,
                          min_width=floor("idx"), min_row_width=floor("ridx"),
                          bwd_mask=bw, min_bwd_width=floor("bidx"))

    none = tree_map(lambda *_: None, masks)
    return tree_map(pack, masks, none if bwd_masks is None else bwd_masks,
                    none if prev is None else prev)


def build_bwd_carrier(bwd_masks):
    """Backward supersets -> the masked kernel's carrier pack (the
    reference's ``core/pack.py::build_bwd_carrier``): ``{"bwd_mask": B}``
    for every dispatched leaf (the same bool tensor, not a copy), ``None``
    elsewhere; ``layers.linear`` routes such an entry to the Top-KAST
    masked VJP."""
    return tree_map(lambda n, m: None if m is None or not _dispatched(n)
                    else {"bwd_mask": m.bool()}, bwd_masks)


def refresh_pack_state(masks, block_shape, *, prev, slack: float = 0.0,
                       bwd_masks=None, device=None):
    """Re-pack after a topology update (right after every RigL update).
    ``prev`` is required: widths never shrink, as in the reference."""
    return build_pack_state(masks, block_shape, slack=slack, device=device,
                            prev=prev, bwd_masks=bwd_masks)


def pack_mismatch(masks, pack, block_shape, bwd_masks=None) -> torch.Tensor:
    """#blocks where the pack disagrees with the masks (and, for entries
    with a superset view, with ``bwd_masks``), as a 0-d int32 tensor on the
    masks' device, computed without a host sync.  Nonzero means a topology
    update ran without ``refresh_pack_state``: the kernels would execute a
    stale topology."""
    from ..kernels.block_sparse_matmul import unpack_block_mask

    total = []

    def count(name, m, e, bw):
        if e is None or m is None:
            return None
        bm = block_mask_of(m, block_shape)
        total.append((unpack_block_mask(e["idx"], e["cnt"], bm.shape[-2]) != bm).sum())
        if bw is not None and "bidx" in e:
            bbm = block_mask_of(bw, block_shape)
            total.append((unpack_block_mask(e["bidx"], e["bcnt"], bbm.shape[-2])
                          != bbm).sum())
        return None

    none = tree_map(lambda *_: None, masks)
    tree_map(count, masks, pack, none if bwd_masks is None else bwd_masks)
    if not total:
        return torch.zeros((), dtype=torch.int32)
    return torch.stack(total).sum().to(torch.int32)


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


def pack_stats(pack) -> dict:
    """Host-side bookkeeping of a PackState (the reference's
    ``core/pack.py::pack_stats``): per entry its grid width against the
    worst case K/bk, the live forward blocks over the whole (groups x cols
    x nkb) block grid (``density``; ``superset_density`` likewise for the
    Top-KAST superset, None without one), and the totals."""
    out: dict = {"layers": {}}
    tight = padded = nnz_total = bnnz_total = cells_total = bcells_total = 0
    for name, e in pack_entries(pack):
        if "idx" not in e:  # masked carrier: nothing packed
            continue
        width, nkb, nnz = int(e["idx"].shape[-1]), int(e["nkb"]), int(e["nnz"])
        groups = int(e["idx"].shape[0]) if e["idx"].dim() == 3 else 1
        cols = int(e["cnt"].shape[-1])
        cells = nkb * cols * groups
        bnnz = int(e["bnnz"]) if "bidx" in e else None
        out["layers"][name] = {
            "width": width, "worst_case": nkb, "grid_fraction": width / nkb,
            "row_width": int(e["ridx"].shape[-1]), "nnz_blocks": nnz,
            "cols": cols, "groups": groups, "density": nnz / cells,
            "superset_density": None if bnnz is None else bnnz / cells,
        }
        tight += width * groups
        padded += nkb * groups
        nnz_total += nnz
        cells_total += cells
        if bnnz is not None:
            bnnz_total += bnnz
            bcells_total += cells
    out["grid_iters_tight"] = tight
    out["grid_iters_padded"] = padded
    out["grid_fraction"] = tight / padded if padded else 1.0
    out["density"] = nnz_total / cells_total if cells_total else 0.0
    out["superset_density"] = bnnz_total / bcells_total if bcells_total else None
    return out


def publish_pack_gauges(metrics, pack) -> None:
    """Set the ``kernel_*`` gauges on a metrics registry (``obs``
    duck-typed: core stays obs-free) from ``pack_stats``: the grid fraction
    and the forward and superset block densities, per layer and under the
    ``_total`` label, as the reference's ``publish_pack_gauges``.  The
    engine publishes once at construction (its pack is constant), the
    trainer after every ``refresh_pack``.  No-op without a pack."""
    if pack is None:
        return
    st = pack_stats(pack)
    gf = metrics.gauge("kernel_grid_fraction",
                       "packed grid width / padded worst case", labels=("layer",))
    dn = metrics.gauge("kernel_block_density",
                       "live forward blocks / full block grid", labels=("layer",))
    sd = metrics.gauge("kernel_superset_density",
                       "Top-KAST backward-superset blocks / full block grid",
                       labels=("layer",))
    gf.labels("_total").set(st["grid_fraction"])
    dn.labels("_total").set(st["density"])
    if st["superset_density"] is not None:
        sd.labels("_total").set(st["superset_density"])
    for name, ls in st["layers"].items():
        gf.labels(name).set(ls["grid_fraction"])
        dn.labels(name).set(ls["density"])
        if ls["superset_density"] is not None:
            sd.labels(name).set(ls["superset_density"])


def validate_pack(pack, *, where: str = "pack") -> int:
    """Host-side CSC/CSR integrity check over every PackState entry.

    Per entry, 2-D and grouped 3-D alike: ``cnt`` matches ``idx`` minus
    its width dim (same for ``rcnt``/``ridx``), the CSR has ``nkb`` rows,
    counts lie in ``[0, width]``, every live index lies inside the block
    grid, and ``sum(cnt) == nnz == sum(rcnt)``.  A superset view (``bidx``/``bcnt``)
    is held to the same invariants, to ``sum(bcnt) == bnnz >= nnz`` and to
    containing every forward-active block.  A masked carrier entry is held
    to a bool ``bwd_mask``.  Raises ``PackIntegrityError`` naming the
    layer; returns the number of entries checked.
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

        if "bwd_mask" in e and "idx" not in e:  # masked carrier: no CSC fields
            if e["bwd_mask"].dtype != torch.bool:
                fail("bwd_mask carrier is not a bool tensor")
            checked += 1
            continue
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
        if "bidx" in e:  # Top-KAST superset CSC: same invariants, wider view
            bidx, bcnt = (torch.as_tensor(e[k]).cpu().numpy() for k in ("bidx", "bcnt"))
            bnnz, bwidth = int(e["bnnz"]), bidx.shape[-1]
            if bidx.shape[:-1] != bcnt.shape:
                fail(f"bidx {bidx.shape} does not extend bcnt {bcnt.shape}")
            if bcnt.size and (bcnt.min() < 0 or bcnt.max() > bwidth):
                fail(f"bcnt out of range [0, bwidth={bwidth}] (max {int(bcnt.max())})")
            blive = np.arange(bwidth) < bcnt[..., None]
            if np.any(blive & ((bidx < 0) | (bidx >= nkb))):
                fail(f"live superset index outside the K-block grid [0, {nkb})")
            if int(bcnt.sum()) != bnnz:
                fail(f"superset nnz inconsistency: sum(bcnt)={int(bcnt.sum())}, "
                     f"recorded bnnz={bnnz}")
            if bnnz < nnz:
                fail(f"superset smaller than forward topology (bnnz={bnnz} < "
                     f"nnz={nnz}) — B must contain A")
            # containment: padded slots scatter into a dummy trailing column
            fwd = np.zeros((*cnt.shape, nkb + 1), bool)
            np.put_along_axis(fwd, np.where(live, idx, nkb), live, axis=-1)
            sup = np.zeros((*bcnt.shape, nkb + 1), bool)
            np.put_along_axis(sup, np.where(blive, bidx, nkb), blive, axis=-1)
            if np.any(fwd[..., :nkb] & ~sup[..., :nkb]):
                fail("forward-active block missing from the backward superset "
                     "CSC — B does not contain A")
        checked += 1
    return checked
