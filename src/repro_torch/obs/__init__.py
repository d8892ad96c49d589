"""Unified observability of the port: metrics registry + span tracing +
exporters.

Own copy of the JAX package's ``obs/`` (plain Python and numpy; the port
imports nothing of that package), the same names, kinds, labels and file
formats, so one dashboard or test reads either package's output:

  * :mod:`.metrics` — Counter/Gauge/Histogram families in a process-wide
    registry, cheap enough for host-side hot loops; ``jit_retraces`` counts
    the port's plan and schedule caches (there is no jit);
  * :mod:`.trace` — bounded-ring span tracer emitting Chrome Trace Event
    Format JSON (Perfetto / chrome://tracing);
  * :mod:`.export` — Prometheus text exposition, JSONL sink, periodic
    flusher;
  * :mod:`.stats_util` — empty-safe percentile/summary helpers shared by
    ``ServeEngine.stats()`` and the request queue.

``Observability`` bundles one registry + one tracer so instrumented
subsystems (``ServeEngine(obs=...)``, ``train_loop(obs=...)``) take a
single handle, and the launch CLIs build one from ``--trace-out`` /
``--metrics-out`` flags.
"""
from __future__ import annotations

from typing import Optional

from .export import JsonlSink, PeriodicFlusher, parse_prometheus_text, prometheus_text
from .metrics import (
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
    jit_retraces,
    kernels_plan_caches,
)
from .stats_util import median, median_by, percentile, summarize
from .trace import SpanTracer

__all__ = [
    "Observability",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Family",
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "exponential_buckets",
    "jit_retraces",
    "kernels_plan_caches",
    "SpanTracer",
    "prometheus_text",
    "parse_prometheus_text",
    "JsonlSink",
    "PeriodicFlusher",
    "percentile",
    "median",
    "median_by",
    "summarize",
]


class Observability:
    """One registry + one tracer, passed as a single handle.

    ``metrics=None`` uses the process-wide :data:`REGISTRY` (the CLI
    default — one exposition file covers everything in the process);
    tests and benches pass a fresh ``MetricsRegistry()`` to isolate.
    """

    def __init__(self, *, metrics: Optional[MetricsRegistry] = None,
                 trace_capacity: int = 65536, pid: int = 0,
                 process_name: Optional[str] = None):
        self.metrics = metrics if metrics is not None else REGISTRY
        self.trace = SpanTracer(
            capacity=trace_capacity, pid=pid, process_name=process_name
        )

    def flusher(self, *, metrics_path=None, trace_path=None,
                events_path=None, interval: float = 5.0) -> PeriodicFlusher:
        """A PeriodicFlusher wired to this bundle's registry and tracer."""
        return PeriodicFlusher(
            registry=self.metrics, tracer=self.trace,
            metrics_path=metrics_path, trace_path=trace_path,
            events_path=events_path, interval=interval,
        )
