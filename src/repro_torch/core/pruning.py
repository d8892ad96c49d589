"""Dense-to-sparse baselines the paper compares against: the port of the JAX
package's ``core/pruning.py``.

- Gradual magnitude pruning (Zhu & Gupta 2018): the sparsity ramps
  s_t = s_f + (s_i - s_f) * (1 - (t - t0) / (t1 - t0))^3 between t0 and t1,
  pruning the lowest-|w| active weights every ``prune_every`` steps.
  Pruned connections never return (masks are monotone).
- SNIP (Lee et al. 2019): a one-shot mask at init by the saliency
  |theta * grad| (paper Appendix M bug #3: gradient magnitude alone is
  catastrophically bad; 'grad' keeps that variant for the ablation).

Exact counts through the same stable double argsort as drop/grow
(``rigl._rank_desc``), so the masks are bit-identical to the reference's
on the same inputs; the ramp is evaluated in float32, as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from .masks import tree_map
from .rigl import _rank_desc

__all__ = ["PruningSchedule", "pruning_target_sparsity", "prune_step", "snip_masks"]


@dataclasses.dataclass(frozen=True)
class PruningSchedule:
    final_sparsity: float
    begin_step: int
    end_step: int
    prune_every: int = 1000
    initial_sparsity: float = 0.0

    def target(self, t):
        """Zhu & Gupta's cubic ramp in float32; ``t`` an int, an array or a
        tensor -> a float32 tensor of its shape."""
        t = torch.as_tensor(t).to(torch.float32)
        span = max(self.end_step - self.begin_step, 1)
        p = torch.clamp((t - self.begin_step) / span, 0.0, 1.0)
        sf, si = self.final_sparsity, self.initial_sparsity
        return sf + (si - sf) * (1.0 - p) ** 3

    def is_prune_step(self, t) -> bool:
        """begin <= t <= end and (t - begin) % prune_every == 0 (a host int:
        the train loop decides on the host)."""
        return (self.begin_step <= t <= self.end_step
                and (t - self.begin_step) % self.prune_every == 0)


def pruning_target_sparsity(sched: PruningSchedule, t):
    return sched.target(t)


def _prune_layer(w, m, target_sparsity):
    """Keep the round((1 - s) * N) largest |w| among the active (monotone).
    Returns (new_mask, w * new_mask)."""
    n_keep = torch.round((1.0 - target_sparsity) * w.numel()).to(torch.int32)
    mag = torch.where(m.reshape(-1).bool(), w.abs().reshape(-1).float(),
                      torch.tensor(-float("inf"), device=w.device))
    kept = (_rank_desc(mag) < n_keep).reshape(w.shape)
    return kept.to(m.dtype), w * kept.to(w.dtype)


def prune_step(params, masks, t, sched: PruningSchedule):
    """Gradual pruning of every masked layer to the step's (uniform) target.
    Returns (new_params, new_masks)."""
    s_t = sched.target(t)
    out = tree_map(lambda _, w, m: (w, None) if m is None else _prune_layer(w, m, s_t)[::-1],
                   params, masks)
    pick = lambda i: tree_map(lambda _, t_: t_[i], out,
                              is_leaf=lambda x: isinstance(x, tuple))
    return pick(0), pick(1)


def snip_masks(params, dense_grads, sparsities, saliency: str = "weight_times_grad"):
    """One-shot SNIP masks: per layer in ``sparsities`` ({path_name: s}),
    keep the round((1 - s) * N) highest saliencies; ``None`` elsewhere.

    saliency: 'weight_times_grad' (|theta * grad|, the correct one) or
    'grad' (|grad|, the Appendix-M bug #3 variant, for the ablation)."""
    if saliency not in ("weight_times_grad", "grad"):
        raise ValueError(saliency)

    def layer(name, w, g):
        s = sparsities.get(name)
        if s is None:
            return None
        score = (w * g if saliency == "weight_times_grad" else g).abs().reshape(-1).float()
        n_keep = int(round((1.0 - s) * w.numel()))
        return (_rank_desc(score) < n_keep).reshape(w.shape)

    return tree_map(layer, params, dense_grads)
