"""Continuous-batching serving of the port: contiguous or paged caches, the
copy-on-write prefix cache, greedy and sampled decoding, and the fault
injector (``faults.py``) that drives its failure edges."""
