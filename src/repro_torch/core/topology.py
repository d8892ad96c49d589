"""Graph-distance telemetry for sparse topologies: the port of the JAX
package's ``core/topology.py``.

"Topological Insights into Sparse Neural Networks" (Liu et al.) shows that
sparse-training methods reaching the same loss can sit on very different
topologies, and that the distance between successive masks fingerprints a
method's exploration.  On index-matched mask trees (successive masks of
one network, or two methods' final masks from one init) the distances
need no graph matching:

  drop/grow counts     edges removed / added by one update
  Jaccard distance     1 - |A∩B| / |A∪B| over the active edge sets
  graph-edit distance  insertions + deletions = the Hamming count
  NHD                  normalized Hamming distance, Hamming / #edges

Masks are torch tensors (on any device) or numpy arrays; every distance
comes from four integer counts per layer pair (|A|, |B|, |A∩B|, size),
taken on the masks' own device, so one update's record costs one pass
over the masks.  ``TopologyTrace.snapshot`` keeps a copy of the masks on
their device (the reference's is a host copy); ``launch/train.py``
records one ``topology_delta`` per update.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .masks import _walk, tree_map

__all__ = [
    "drop_grow_counts",
    "jaccard_distance",
    "graph_edit_distance",
    "normalized_hamming_distance",
    "topology_delta",
    "TopologyTrace",
    "cross_method_distances",
]


def _leaves(tree):
    return [leaf for _, leaf in _walk(tree, ())]


def _counts(a, b) -> list[tuple[int, int, int, int]]:
    """(|A|, |B|, |A∩B|, size) for every aligned mask pair of two trees
    (leaves that are None in both skipped)."""
    fa, fb = _leaves(a), _leaves(b)
    if len(fa) != len(fb):
        raise ValueError(f"mask trees differ in structure: {len(fa)} vs {len(fb)} leaves")
    out = []
    for ma, mb in zip(fa, fb):
        if ma is None and mb is None:
            continue
        if ma is None or mb is None:
            raise ValueError("mask trees disagree on which leaves are dense")
        if tuple(ma.shape) != tuple(mb.shape):
            raise ValueError(f"mask shapes differ: {tuple(ma.shape)} vs {tuple(mb.shape)}")
        if torch.is_tensor(ma) or torch.is_tensor(mb):
            ta = torch.as_tensor(ma).bool()
            tb = torch.as_tensor(mb).bool().to(ta.device)
            c = torch.stack([ta.sum(), tb.sum(), (ta & tb).sum()]).tolist()
        else:
            na, nb = np.asarray(ma, bool), np.asarray(mb, bool)
            c = [int(na.sum()), int(nb.sum()), int((na & nb).sum())]
        out.append((int(c[0]), int(c[1]), int(c[2]), int(np.prod(ma.shape))))
    return out


def _summary(a, b) -> dict[str, int]:
    na = nb = inter = size = 0
    for ca, cb, ci, n in _counts(a, b):
        na, nb, inter, size = na + ca, nb + cb, inter + ci, size + n
    return {"dropped": na - inter, "grown": nb - inter, "inter": inter,
            "union": na + nb - inter, "size": size}


def drop_grow_counts(prev, new) -> tuple[int, int]:
    """(#edges dropped, #edges grown) between two masks of one network:
    active before and inactive after, and the reverse (disjoint)."""
    s = _summary(prev, new)
    return s["dropped"], s["grown"]


def _jaccard(s) -> float:
    return 1.0 - s["inter"] / s["union"] if s["union"] else 0.0


def _nhd(s) -> float:
    return (s["dropped"] + s["grown"]) / s["size"] if s["size"] else 0.0


def jaccard_distance(a, b) -> float:
    """1 - |A∩B| / |A∪B| over the pooled active edge sets (0 = identical)."""
    return _jaccard(_summary(a, b))


def graph_edit_distance(a, b) -> int:
    """Edge insertions + deletions between same-shape masks: the Hamming
    count."""
    s = _summary(a, b)
    return s["dropped"] + s["grown"]


def normalized_hamming_distance(a, b) -> float:
    """Hamming count / total edges, in [0, 1] (0 = identical topology)."""
    return _nhd(_summary(a, b))


def topology_delta(prev, new, *, step: Optional[int] = None) -> dict[str, Any]:
    """One update's telemetry record (one pass over the masks)."""
    s = _summary(prev, new)
    rec = {"dropped": s["dropped"], "grown": s["grown"], "jaccard_dist": _jaccard(s),
           "graph_edit_dist": s["dropped"] + s["grown"], "nhd": _nhd(s)}
    if step is not None:
        rec["step"] = int(step)
    return rec


class TopologyTrace:
    """Per-update ``topology_delta`` records of one training run: snapshot
    the masks before an update, ``record`` after it, read ``summary()`` at
    the end (always finite: a run with no update reports zeros)."""

    def __init__(self):
        self.events: list[dict[str, Any]] = []

    def snapshot(self, masks):
        """A copy of the masks as bool tensors (numpy masks stay numpy)."""
        return tree_map(lambda _, m: None if m is None else (
            m.detach().bool().clone() if torch.is_tensor(m) else np.array(m, bool)), masks)

    def record(self, prev, new, *, step: Optional[int] = None) -> dict[str, Any]:
        rec = topology_delta(prev, new, step=step)
        self.events.append(rec)
        return rec

    def summary(self) -> dict[str, Any]:
        ev = self.events
        if not ev:
            return {"n_updates": 0, "dropped_total": 0, "grown_total": 0,
                    "jaccard_dist_mean": 0.0, "graph_edit_dist_total": 0, "nhd_mean": 0.0}
        return {
            "n_updates": len(ev),
            "dropped_total": int(sum(e["dropped"] for e in ev)),
            "grown_total": int(sum(e["grown"] for e in ev)),
            "jaccard_dist_mean": float(np.mean([e["jaccard_dist"] for e in ev])),
            "graph_edit_dist_total": int(sum(e["graph_edit_dist"] for e in ev)),
            "nhd_mean": float(np.mean([e["nhd"] for e in ev])),
        }


def cross_method_distances(masks_by_method: Mapping[str, Any], *,
                           reference: str = "rigl") -> dict[str, dict[str, float]]:
    """Final-mask distances of each method against ``reference``'s:
    {method: {jaccard_dist_vs_<ref>, nhd_vs_<ref>}}; methods whose mask
    trees do not match the reference's shapes are skipped."""
    out: dict[str, dict[str, float]] = {}
    ref = masks_by_method.get(reference)
    if ref is None:
        return out
    for name, masks in masks_by_method.items():
        try:
            s = _summary(ref, masks)
        except ValueError:
            continue  # incompatible shapes (e.g. small_dense): no column
        out[name] = {f"jaccard_dist_vs_{reference}": _jaccard(s),
                     f"nhd_vs_{reference}": _nhd(s)}
    return out
