"""Planted sparse-teacher task, the port's copy of the JAX package's
``data/teacher.py``: a fixed random sparse two-layer network whose
topology is known generates the targets, so a student trained at matched
sparsity shows whether the grow criterion finds useful connections.

The draws come from a ``torch.Generator``, NOT from the reference's
``jax.random`` streams: the same arguments give other weights, masks and
inputs than the JAX package.  The function is the same: handed the
reference teacher's arrays and the same ``x``, ``teacher_targets`` gives
the reference's noise-free targets.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_teacher", "teacher_targets", "teacher_batch"]

_MASK64 = (1 << 63) - 1


def make_teacher(gen: torch.Generator, d_in: int = 32, d_hidden: int = 128,
                 d_out: int = 16, sparsity: float = 0.9):
    """{"w1": (d_in, d_hidden), "w2": (d_hidden, d_out)} f32 on the
    generator's device: fan-in scaled normal weights, each kept with
    probability ``1 - sparsity`` (zero elsewhere)."""
    dev = gen.device
    w1 = torch.randn(d_in, d_hidden, generator=gen, device=dev) / np.sqrt(d_in)
    w2 = torch.randn(d_hidden, d_out, generator=gen, device=dev) / np.sqrt(d_hidden)
    m1 = torch.rand(w1.shape, generator=gen, device=dev) > sparsity
    m2 = torch.rand(w2.shape, generator=gen, device=dev) > sparsity
    return {"w1": w1 * m1, "w2": w2 * m2}


def teacher_targets(teacher, x):
    """The teacher's noise-free function: relu(x @ w1) @ w2."""
    return torch.relu(x @ teacher["w1"]) @ teacher["w2"]


def teacher_batch(teacher, step: int, batch: int = 256, *, seed: int = 5,
                  noise: float = 0.01):
    """(x (batch, d_in), y (batch, d_out)) on the teacher's device: normal
    inputs and the teacher's targets plus ``noise`` times normal noise, a
    pure function of (seed, step)."""
    w1 = teacher["w1"]
    h = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9) & _MASK64
    gen = torch.Generator(device=w1.device).manual_seed(h)
    x = torch.randn(batch, w1.shape[0], generator=gen, device=w1.device)
    y = teacher_targets(teacher, x)
    return x, y + noise * torch.randn(y.shape, generator=gen, device=w1.device)
