"""Sparsity distributions: Uniform, Erdos-Renyi (ER), Erdos-Renyi-Kernel (ERK).

Own numpy copy of the JAX package's ``core/distributions.py`` (the solver is
plain numpy there too), plus ``sparsity_map`` from its
``training/steps.py``: the per-layer sparsities a serve or train state is
initialised with.

Given a target *overall* sparsity S and the shapes of the sparsifiable layers,
produce per-layer sparsities s_l with  sum_l s_l * N_l / sum_l N_l == S.

ER/ERK follow Mocanu et al. (2018) / Evci et al. (2020): layer l keeps a density
proportional to (sum of its dims)/(prod of its dims) — kernel dims included for
ERK.  The scale factor eps is solved exactly with the iterative capping scheme
used in google-research/rigl: layers whose implied density would exceed 1 are
pinned dense and eps re-solved over the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "LayerSpec",
    "uniform_distribution",
    "erdos_renyi_distribution",
    "sparsity_overall",
    "validate_distribution",
    "get_distribution",
    "sparsity_map",
]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """A sparsifiable layer as seen by the distribution solver.

    shape: full weight shape.  For dense (matmul) layers this is (n_in, n_out)
      or any rank — the last two dims are treated as (in, out) fan dims and
      any leading dims (conv kernel h/w, experts, stacked layers) as "kernel"
      dims included only by ERK.
    dense: if True the layer is excluded from sparsification (kept dense).
    """

    name: str
    shape: tuple[int, ...]
    dense: bool = False

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def er_raw(self, kernel_aware: bool) -> float:
        """Unit-eps density: (n_in+n_out[+kernel dims]) / prod(dims)."""
        *kernel, n_in, n_out = self.shape
        num = n_in + n_out + (sum(kernel) if kernel_aware else 0)
        den = n_in * n_out * (int(np.prod(kernel)) if kernel else 1)
        if kernel and not kernel_aware:
            # plain ER on a conv-like layer: treat kernel dims as part of fan-in
            den = self.size
        return num / den


def uniform_distribution(
    layers: Sequence[LayerSpec], sparsity: float, dense_first: bool = True
) -> dict[str, float]:
    """Uniform: every sparsifiable layer gets s_l = S.

    Per the paper, the first sparsifiable layer may be kept dense
    (``dense_first``); unlike ER/ERK no re-normalization is applied (the
    paper's uniform numbers also report overall sparsity slightly below S).
    """
    out: dict[str, float] = {}
    first = True
    for l in layers:
        if l.dense or (dense_first and first and not l.dense):
            out[l.name] = 0.0
            if not l.dense:
                first = False
            continue
        out[l.name] = float(sparsity)
    return out


def erdos_renyi_distribution(
    layers: Sequence[LayerSpec],
    sparsity: float,
    kernel_aware: bool = True,
) -> dict[str, float]:
    """ER (kernel_aware=False) / ERK (kernel_aware=True) distribution.

    Solves for eps such that total nnz matches the target, capping layers at
    density 1.0 (iteratively, as in the official implementation).
    """
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0,1), got {sparsity}")
    sizes = {l.name: l.size for l in layers}
    target_nnz = (1.0 - sparsity) * sum(s for s in sizes.values())

    dense_names = {l.name for l in layers if l.dense}
    raw = {l.name: l.er_raw(kernel_aware) for l in layers if not l.dense}

    # Iteratively pin layers that would exceed density 1.
    pinned = set(dense_names)
    while True:
        pinned_nnz = sum(sizes[n] for n in pinned)
        free = [l for l in layers if l.name not in pinned]
        if not free:
            break
        denom = sum(raw[l.name] * sizes[l.name] for l in free)
        if denom <= 0:
            break
        eps = (target_nnz - pinned_nnz) / denom
        over = [l.name for l in free if eps * raw[l.name] > 1.0]
        if not over:
            break
        pinned.update(over)

    out: dict[str, float] = {}
    for l in layers:
        if l.name in pinned:
            out[l.name] = 0.0
        else:
            density = min(1.0, max(0.0, eps * raw[l.name]))
            out[l.name] = float(1.0 - density)
    return out


def sparsity_overall(
    layers: Sequence[LayerSpec], sparsities: Mapping[str, float]
) -> float:
    total = sum(l.size for l in layers)
    nnz = sum(l.size * (1.0 - sparsities[l.name]) for l in layers)
    return 1.0 - nnz / total


def validate_distribution(sparsities: Mapping[str, float]) -> None:
    for name, s in sparsities.items():
        if not (0.0 <= s < 1.0):
            raise ValueError(f"layer {name}: sparsity {s} outside [0,1)")


def get_distribution(
    kind: str,
    layers: Sequence[LayerSpec],
    sparsity: float,
    dense_first: bool = True,
) -> dict[str, float]:
    """kind in {uniform, er, erk}."""
    if sparsity == 0.0:
        return {l.name: 0.0 for l in layers}
    if kind == "uniform":
        d = uniform_distribution(layers, sparsity, dense_first=dense_first)
    elif kind == "er":
        d = erdos_renyi_distribution(layers, sparsity, kernel_aware=False)
    elif kind == "erk":
        d = erdos_renyi_distribution(layers, sparsity, kernel_aware=True)
    else:
        raise ValueError(f"unknown distribution kind: {kind!r}")
    validate_distribution(d)
    return d


def sparsity_map(cfg, params, sparse_flags) -> dict[str, float]:
    """Per-path target sparsities from the config's distribution.

    As in the reference, the distribution (and its nnz budget) is solved
    over the MASKED layers only: embeddings, norms and the LM head are
    outside it.  ``params`` and ``sparse_flags`` are the trees ``init_lm``
    returns; the names are ``path_name`` strings (``layers/0/attn/wq/w``).
    """
    from .masks import tree_paths

    flat_p = tree_paths(params)
    specs = [
        LayerSpec(name, tuple(flat_p[name].shape))
        for name, flag in tree_paths(sparse_flags).items() if flag
    ]
    sp = cfg.sparse
    return get_distribution(sp.distribution, specs, sp.sparsity,
                            dense_first=False)
