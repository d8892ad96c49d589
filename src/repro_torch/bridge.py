"""Bridge from the JAX package's serving and train states to the port's
tensors.

The JAX side hands over numpy arrays keyed by ``path_name`` strings
(``layers/0/attn/wq/w``), the naming both packages share; this module never
imports JAX.  ``params_from_flat`` rebuilds the params tree,
``masks_from_flat`` and ``pack_from_flat`` rebuild trees that mirror it
(``None`` where the reference has no mask or entry; pack entries keep the
Top-KAST superset view ``bidx``/``bcnt``/``bnnz`` when the reference's
carry one, a grouped bank's stacked entries (``idx (G, N/bn, width)``,
the MoE experts') keep their leading group dim, and the masked kernel's
``{"bwd_mask": B}`` carrier entries come across as bool tensors).
``train_state_from_flat`` assembles a whole train state (params, masks,
backward supersets, pack, optimizer state, SNFS's dense momentum, step and
the non-finite counter), an MoE model's included: 3-D expert banks with their masks,
supersets and grouped packs (superset view ``bidx``/``bcnt``) or carriers.  ``flat_of`` and ``pack_flat_of`` go the other way, so
the tests can round-trip a state.  Bare leaves (no ``{"w": ...}`` bundle:
sLSTM's ``slstm/r``, hymba's ``ssm/a_log``, ``ssm/d_skip``, ``ssm/dt_bias``)
come across by their path names like any other, and so do the frontend
configs' trees: ``frontend_proj`` beside a frames config's untied
``head`` (no ``embed``) or a patch config's tied ``embed`` (no ``head``).
bf16 leaves cross in either direction with their bits (grok-1-314b's
masters; Adam's moments, bf16 before their first update and f32 after
it).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.masks import tree_map, tree_paths
from .core.pack import pack_entries

__all__ = ["params_from_flat", "masks_from_flat", "pack_from_flat",
           "train_state_from_flat", "flat_of", "pack_flat_of"]

_PACK_ARRAYS = ("idx", "cnt", "ridx", "rcnt", "bidx", "bcnt")
_PACK_INTS = ("nnz", "nkb", "bnnz")


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


def _tensor(a) -> torch.Tensor:
    """numpy array -> tensor; bf16 arrays (ml_dtypes) keep their bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_flat(flat: Mapping[str, np.ndarray], device):
    """{path_name: array} -> params tree of tensors on ``device``."""
    return _unflatten({n: _tensor(a).to(device) for n, a in flat.items()})


def masks_from_flat(flat: Mapping[str, np.ndarray], params, device):
    """{path_name: bool array} -> mask tree mirroring ``params``."""
    return tree_map(
        lambda n, _: (torch.from_numpy(np.array(flat[n], bool)).to(device)
                      if n in flat else None),
        params,
    )


def pack_from_flat(flat: Mapping[str, Mapping[str, Any]], params, device):
    """{path_name: reference pack entry} -> PackState tree mirroring
    ``params`` (int32 tensors on ``device``; nnz and nkb as ints; a
    carrier's ``bwd_mask`` as a bool tensor)."""

    def entry(n, _):
        e = flat.get(n)
        if e is None:
            return None
        if "bwd_mask" in e:
            return {"bwd_mask": torch.from_numpy(np.array(e["bwd_mask"], bool)).to(device)}
        out = {k: torch.from_numpy(np.array(e[k], np.int32)).to(device)
               for k in _PACK_ARRAYS if k in e}
        out.update({k: int(e[k]) for k in _PACK_INTS if k in e})
        return out

    return tree_map(entry, params)


def train_state_from_flat(params, masks, *, pack=None, bwd_masks=None, opt,
                          dense_mom=None, step: int = 0, nonfinite_steps: int = 0,
                          seed: int = 0, device):
    """A reference train state, flattened, -> the port's train state
    (``training/steps.py`` layout).  ``opt`` is ``{"momentum": flat}`` (sgd,
    f32 or bf16 arrays, an MoE model's 3-D bank momenta included: the dtype
    and shape come across, so both packages can start the fused epilogue
    from one state) or ``{"m": flat, "v": flat,
    "count": int}`` (adam); ``dense_mom`` is SNFS's dense momentum
    ``{path_name: array}`` over every param; ``seed`` seeds the
    port's own later draws (supersets, masks), which are not the
    reference's threefry streams."""
    p = params_from_flat(params, device)
    state = {
        "step": int(step), "seed": int(seed), "params": p,
        "masks": masks_from_flat(masks, p, device),
        "nonfinite_steps": torch.tensor(int(nonfinite_steps), dtype=torch.int32,
                                        device=device),
        "opt": {k: (torch.tensor(int(v), dtype=torch.int32, device=device)
                    if k == "count" else params_from_flat(v, device))
                for k, v in opt.items()},
    }
    if bwd_masks is not None:
        state["bwd_masks"] = masks_from_flat(bwd_masks, p, device)
    if pack is not None:
        state["pack"] = pack_from_flat(pack, p, device)
    if dense_mom is not None:
        state["dense_mom"] = params_from_flat(dense_mom, device)
    return state


def flat_of(tree) -> dict[str, np.ndarray]:
    """Tree of tensors -> {path_name: numpy array} (None leaves dropped):
    a bf16 leaf (grok's masters, Adam's moments before their first update)
    as an ``ml_dtypes.bfloat16`` array with the same bits, so it goes back
    to the JAX package in its own dtype (``ml_dtypes``, which ships with
    JAX, is imported only then)."""
    def host(t):
        t = t.detach().cpu()
        if t.dtype != torch.bfloat16:
            return t.numpy()
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)

    return {n: host(t) for n, t in tree_paths(tree).items()}


def pack_flat_of(pack) -> dict[str, dict[str, Any]]:
    """PackState tree -> {path_name: {field: numpy array or int}}."""
    return {
        n: {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in e.items()}
        for n, e in pack_entries(pack)
    }
