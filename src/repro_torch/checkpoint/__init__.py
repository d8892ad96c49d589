"""Crash-atomic, bit-packed, async checkpoints of the port's train state."""
from .checkpoint import Checkpointer, latest_step, restore, save  # noqa: F401
