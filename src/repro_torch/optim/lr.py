"""LR schedules: own copy of the JAX package's ``optim/lr.py``.

Evaluated in float32 as the reference evaluates them (``jnp.float32``
arithmetic on the step), returned as a 0-d float32 tensor on ``device``
(the step counter's), so a training step reads its learning rate without a
host sync.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["LRSchedule"]


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    kind: str = "warmup_cosine"  # warmup_cosine | step_drops | constant
    base_lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10_000
    # step_drops (paper ImageNet: x0.1 at epochs 30/70/90 after 5-epoch warmup)
    drop_steps: tuple[int, ...] = ()
    drop_factor: float = 0.1

    def __call__(self, step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(s / max(self.warmup_steps, 1), max=1.0)
        if self.kind == "constant":
            return self.base_lr * warm
        if self.kind == "warmup_cosine":
            t = torch.clamp(
                (s - self.warmup_steps)
                / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0,
            )
            return self.base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))
        if self.kind == "step_drops":
            drops = sum((s >= d).float() for d in self.drop_steps)
            return self.base_lr * warm * self.drop_factor**drops
        raise ValueError(self.kind)
