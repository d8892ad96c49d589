"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A machine
without a card raises instead of quietly running the plain CPU versions: a
run that was meant for the kernels never reports CPU numbers as the card's.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels"
        )
    return dev
