"""Continuous-batching serving of the port (contiguous caches, greedy)."""
