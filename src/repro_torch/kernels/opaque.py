"""The kernels' autograd Functions as opaque regions for a selective remat
policy.

The reference's ``remat_policy='dots'`` (``jax.checkpoint_policies.
checkpoint_dots``) saves the outputs of ``dot_general`` and nothing of a
``pallas_call``: a kernel's forward is recomputed whole, as under 'none'.
The port's kernel Functions raise a thread-local depth while their forward
runs (``opaque``), and the policy (``models/model.py::dots_policy``) asks
``inside_kernel`` and recomputes every aten op under it: the plain
versions' products on the CPU, the allocations and fills around a launch on
the card.  The depth is per thread because autograd may run a checkpoint's
recompute on its own device thread; the forward and the policy it consults
always share one.
"""
from __future__ import annotations

import functools
import threading

__all__ = ["opaque", "inside_kernel"]

_STATE = threading.local()


def inside_kernel() -> bool:
    """Is this thread inside the forward of a kernel's Function?"""
    return getattr(_STATE, "depth", 0) > 0


def opaque(forward):
    """Decorate a kernel Function's ``forward`` (under ``@staticmethod``)."""

    @functools.wraps(forward)
    def run(*args, **kwargs):
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        try:
            return forward(*args, **kwargs)
        finally:
            _STATE.depth -= 1

    return run
