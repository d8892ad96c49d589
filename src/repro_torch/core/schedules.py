"""Mask-update schedules (paper §3.2 + Appendix G): own copy of the JAX
package's ``core/schedules.py``.

``f_decay(t)`` gives the fraction of each layer's connections updated at
step t, computed in float32 as the reference computes it (the drop count
``floor(fraction * n_active)`` depends on its last bits).  Takes python
ints or tensors; returns a float32 tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = ["UpdateSchedule", "cosine_decay", "constant_decay", "inverse_power_decay"]


def _f32(t):
    return torch.as_tensor(t).to(torch.float32)


def cosine_decay(t, alpha: float, t_end: int):
    """f_decay(t) = alpha/2 * (1 + cos(t*pi/T_end))   (paper eq., default)."""
    return 0.5 * alpha * (1.0 + torch.cos(math.pi * _f32(t) / t_end))


def constant_decay(t, alpha: float, t_end: int):
    return alpha * torch.ones_like(_f32(t))


def inverse_power_decay(t, alpha: float, t_end: int, k: int = 3):
    """alpha * (1 - t/T_end)^k;  k=1 is the linear schedule (Appendix G)."""
    return alpha * (1.0 - _f32(t) / t_end) ** k


_DECAYS: dict[str, Callable] = {
    "cosine": cosine_decay,
    "constant": constant_decay,
    "linear": lambda t, a, te: inverse_power_decay(t, a, te, k=1),
    "inverse_power": inverse_power_decay,
}


@dataclasses.dataclass(frozen=True)
class UpdateSchedule:
    """Paper defaults: delta_t=100, alpha=0.3, t_end = 3/4 of training."""

    delta_t: int = 100
    t_end: int = 25_000
    alpha: float = 0.3
    decay: str = "cosine"

    def fraction(self, t):
        return _DECAYS[self.decay](t, self.alpha, self.t_end)

    def is_update_step(self, t: int) -> bool:
        """t % delta_t == 0 and 0 < t < t_end (host ints: the train loop
        decides on the host which step function runs)."""
        return t % self.delta_t == 0 and 0 < t < self.t_end
