"""Shared summary-statistics helpers (empty-population-safe).

Own copy of the JAX package's ``obs/stats_util.py``: the percentile and
summary shapes ``ServeEngine.stats()`` and the request queue report.  Every
helper tolerates an empty population (returns 0.0 / empty summary) because
serve stats get queried before the first request completes and a chaos run
can shed 100% of a stream.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = ["percentile", "summarize", "median", "median_by"]


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) of ``values``; 0.0 for an empty population."""
    vals = np.asarray(values, dtype=np.float64)
    if vals.size == 0:
        return 0.0
    return float(np.percentile(vals, q))


def median(values: Sequence[float]) -> float:
    return percentile(values, 50)


def summarize(values: Sequence[float],
              qs: Iterable[float] = (50, 95, 99)) -> dict:
    """{mean, min, max, n, p<q>...} — the one summary shape every bench
    writes into its BENCH_*.json.  Empty population -> all zeros, n=0."""
    vals = np.asarray(values, dtype=np.float64)
    out = {
        "n": int(vals.size),
        "mean": float(vals.mean()) if vals.size else 0.0,
        "min": float(vals.min()) if vals.size else 0.0,
        "max": float(vals.max()) if vals.size else 0.0,
    }
    for q in qs:
        key = f"p{int(q) if float(q).is_integer() else q}"
        out[key] = percentile(vals, q)
    return out


def median_by(runs: Sequence[dict], key: str) -> Optional[dict]:
    """The run dict whose ``key`` value is the median of the population
    (upper-middle for even counts, matching the previous serve_bench
    ``_median_by_throughput`` semantics).  None for an empty population."""
    if not runs:
        return None
    ordered = sorted(runs, key=lambda r: r[key])
    return ordered[len(ordered) // 2]
