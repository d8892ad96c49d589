"""Process-wide metrics registry: Counter / Gauge / Histogram families.

The measurement spine of the observability layer (docs/observability.md):
everything the trainer and the serving engine want to report continuously —
slot occupancy, pool pages, loss, pack grid fractions, step latencies — lands
in one ``MetricsRegistry`` as a *family* of labeled series, cheap enough to
update from the host side of a hot loop:

  * a Counter/Gauge update is one python attribute add/store (no locks, no
    string formatting, no allocation — the label resolution happens ONCE when
    the caller binds the child via ``Family.labels`` and keeps the handle);
  * a Histogram observe is one ``bisect`` over its (static, pre-validated)
    bucket bounds plus two adds — the exponential default
    (``exponential_buckets``) spans 100 µs → ~100 s in 18 buckets, wide
    enough for queue waits and train steps alike;
  * ``snapshot()`` is the only walk over everything, taken at flush cadence
    (obs/export.py), never per event.

Zero new dependencies: stdlib only.  Updates are deterministic — two
identical seeded runs produce bit-identical snapshots (the ``obs`` test tier
pins this), which is what makes metrics usable as a regression oracle and
not just a dashboard feed.

The module-level ``REGISTRY`` is the process-wide default (Prometheus-style);
subsystems accept an explicit registry so tests and benches can isolate.
``jit_retraces`` is the counter both the trainer and
``ServeEngine.stats()`` use to surface ``n_retraces``.  The port compiles
nothing per shape, so it counts what does grow with new shapes: the misses
of the ``functools.lru_cache`` plan and schedule builders it is given
(``kernels_plan_caches``), which is the reference's own rule for its lru
wrappers.
"""
from __future__ import annotations

import bisect
import math
import re
from typing import Any, Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Family",
    "MetricsRegistry",
    "REGISTRY",
    "exponential_buckets",
    "jit_retraces",
    "kernels_plan_caches",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def exponential_buckets(start: float, factor: float, count: int) -> tuple:
    """``count`` upper bounds ``start * factor**i`` — the Prometheus-style
    exponential ladder.  start > 0, factor > 1, count >= 1 (validated here so
    a bad ladder fails at registration, not at the first observe)."""
    if start <= 0:
        raise ValueError(f"exponential_buckets: start must be > 0, got {start}")
    if factor <= 1:
        raise ValueError(f"exponential_buckets: factor must be > 1, got {factor}")
    if count < 1:
        raise ValueError(f"exponential_buckets: count must be >= 1, got {count}")
    return tuple(start * factor**i for i in range(count))


#: default histogram ladder: 100 µs .. ~107 s in 18 powers of 2 — covers a
#: single decode-step dispatch and a multi-second cold prefill in one ladder
DEFAULT_BUCKETS = exponential_buckets(1e-4, 2.0, 18)


class Counter:
    """Monotone accumulator.  ``inc`` rejects negative deltas — a counter
    that can go down is a gauge wearing the wrong type string, and the
    Prometheus exposition (obs/export.py) would mislead rate() queries."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc of negative delta {n}")
        self.value += n


class Gauge:
    """Point-in-time value (set wins, no history)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Cumulative-bucket histogram over static upper bounds.

    ``observe`` uses ``le`` (<=) bucket semantics exactly as the Prometheus
    text exposition declares them, so the round-trip test can compare
    emitted cumulative counts against a reference prefix-sum without any
    off-by-one fudging.  Bounds must be finite and strictly increasing; the
    implicit +Inf bucket is the trailing ``counts`` slot.
    """

    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(float(x) for x in bounds)
        if not b:
            raise ValueError("Histogram needs at least one bucket bound")
        if any(not math.isfinite(x) for x in b):
            raise ValueError(f"Histogram bounds must be finite, got {b}")
        if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"Histogram bounds must strictly increase: {b}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)  # trailing slot = (+last, +Inf]
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # first bound >= v  <=>  the smallest bucket with v <= le
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative_count), ..., (inf, total)] — the exposition form."""
        out, acc = [], 0
        for le, c in zip(self.bounds, self.counts):
            acc += c
            out.append((le, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric with a fixed label schema and one child series per
    label-value tuple.  ``labels(*values)`` resolves (and memoizes) the
    child; a label-free family proxies ``inc``/``set``/``observe`` straight
    to its single default child so call sites stay one line."""

    __slots__ = ("name", "help", "kind", "labelnames", "_children", "_buckets")

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (), buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, Any] = {}
        self._buckets = tuple(buckets) if buckets is not None else None
        if not self.labelnames:
            self.labels()  # materialize the default child eagerly

    def labels(self, *values):
        """Child series for one label-value tuple (created on first use).
        Values are stringified — label values are identity, not data."""
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(values)} label values for "
                f"labels {self.labelnames}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            cls = _KINDS[self.kind]
            child = (
                cls(self._buckets) if self.kind == "histogram" and self._buckets
                else cls()
            )
            self._children[key] = child
        return child

    # label-free ergonomic proxies (guarded: labeled families must bind first)
    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels(...)"
            )
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def series(self):
        """(label_values_tuple, child) pairs in creation order — snapshot
        iteration is deterministic because dicts preserve insertion order."""
        return self._children.items()


class MetricsRegistry:
    """Name -> Family map with idempotent registration.

    ``counter``/``gauge``/``histogram`` are get-or-create: a subsystem can be
    constructed twice against the same registry (two engines in one bench
    process) and share series instead of colliding.  Re-registering with a
    DIFFERENT kind or label schema is a loud error — that is always a bug.
    """

    def __init__(self):
        self._families: dict[str, Family] = {}

    def _register(self, name: str, kind: str, help: str,
                  labels: Sequence[str], buckets=None) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} with "
                    f"labels {fam.labelnames}; asked for {kind} with "
                    f"labels {tuple(labels)}"
                )
            return fam
        fam = Family(name, kind, help, labels, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._register(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._register(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), buckets=None) -> Family:
        return self._register(name, "histogram", help, labels, buckets)

    def get(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    def snapshot(self) -> dict:
        """Deterministic point-in-time view of every series:
        {name: {kind, help, labelnames, series: [{labels, ...values}]}}.
        Histogram series carry (bounds, counts, sum, count) — enough to
        rebuild the cumulative exposition exactly (obs/export.py)."""
        out: dict[str, Any] = {}
        for name, fam in self._families.items():
            series = []
            for key, child in fam.series():
                s: dict[str, Any] = {
                    "labels": dict(zip(fam.labelnames, key))
                }
                if fam.kind == "histogram":
                    s["bounds"] = list(child.bounds)
                    s["counts"] = list(child.counts)
                    s["sum"] = child.sum
                    s["count"] = child.count
                else:
                    s["value"] = child.value
                series.append(s)
            out[name] = {
                "kind": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "series": series,
            }
        return out


#: the process-wide default registry (subsystems take ``registry=`` overrides
#: so tests and benches can isolate; the CLIs use this one)
REGISTRY = MetricsRegistry()


def jit_retraces(*fns) -> int:
    """Total ``cache_info().misses`` over ``functools.lru_cache`` wrappers:
    the number of distinct (shape, plan) variants built so far.

    In the reference this also reads ``jax.jit`` cache sizes; the port has
    no jit, so its ``n_retraces`` counts the builds of the kernels' launch
    plans and the flash schedules (``kernels_plan_caches()``): a new pack
    width, prompt bucket or row count builds a new plan, exactly where the
    reference would retrace.  Growth during steady-state traffic is the
    same pack-width-hysteresis / bucket-churn signal.  Arguments without
    ``cache_info`` count 0.
    """
    n = 0
    for f in fns:
        info = getattr(f, "cache_info", None)
        if info is not None:
            n += info().misses
    return n


def kernels_plan_caches() -> tuple:
    """The port's lru-cached launch-plan and schedule builders: the
    block-sparse forward, dgrad and wgrad plans, the masked plan, and the
    flash kernels' schedules and plans (imported here, when asked for, so
    the metrics module stays import-light)."""
    from ..kernels import block_sparse_matmul as bsm
    from ..kernels import flash_attention as fa
    from ..kernels import masked_matmul as mm

    return (bsm._fwd_plan_for, bsm._dx_plan_for, bsm._dw_plan_for,
            mm._fwd_plan_for, fa._n_sm, fa._bwd_plan_for, fa._schedule_on)
