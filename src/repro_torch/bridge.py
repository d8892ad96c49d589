"""Bridge from the JAX package's serving state to the port's tensors.

The JAX side hands over numpy arrays keyed by ``path_name`` strings
(``layers/0/attn/wq/w``), the naming both packages share; this module never
imports JAX.  ``params_from_flat`` rebuilds the params tree,
``masks_from_flat`` and ``pack_from_flat`` rebuild trees that mirror it
(``None`` where the reference has no mask or entry).  Pack entries drop the
Top-KAST superset view (``bidx``/``bcnt``/``bnnz``), which only the wgrad
kernel reads.  ``flat_of`` and ``pack_flat_of`` go the other way, so the
tests can round-trip a state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.masks import tree_map, tree_paths
from .core.pack import pack_entries

__all__ = ["params_from_flat", "masks_from_flat", "pack_from_flat",
           "flat_of", "pack_flat_of"]

_PACK_ARRAYS = ("idx", "cnt", "ridx", "rcnt")


def _unflatten(flat: Mapping[str, Any]):
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        *parents, last = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def params_from_flat(flat: Mapping[str, np.ndarray], device):
    """{path_name: array} -> params tree of tensors on ``device``."""
    return _unflatten({
        n: torch.from_numpy(np.array(a)).to(device) for n, a in flat.items()
    })


def masks_from_flat(flat: Mapping[str, np.ndarray], params, device):
    """{path_name: bool array} -> mask tree mirroring ``params``."""
    return tree_map(
        lambda n, _: (torch.from_numpy(np.array(flat[n], bool)).to(device)
                      if n in flat else None),
        params,
    )


def pack_from_flat(flat: Mapping[str, Mapping[str, Any]], params, device):
    """{path_name: reference pack entry} -> PackState tree mirroring
    ``params`` (int32 tensors on ``device``; nnz and nkb as ints)."""

    def entry(n, _):
        e = flat.get(n)
        if e is None:
            return None
        out = {k: torch.from_numpy(np.array(e[k], np.int32)).to(device)
               for k in _PACK_ARRAYS}
        out["nnz"], out["nkb"] = int(e["nnz"]), int(e["nkb"])
        return out

    return tree_map(entry, params)


def flat_of(tree) -> dict[str, np.ndarray]:
    """Tree of tensors -> {path_name: numpy array} (None leaves dropped)."""
    return {n: t.detach().cpu().numpy() for n, t in tree_paths(tree).items()}


def pack_flat_of(pack) -> dict[str, dict[str, Any]]:
    """PackState tree -> {path_name: {field: numpy array or int}}."""
    return {
        n: {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in e.items()}
        for n, e in pack_entries(pack)
    }
