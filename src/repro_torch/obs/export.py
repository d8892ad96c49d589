"""Exporters: Prometheus text exposition, JSONL event sink, periodic flusher.

The registry (obs/metrics.py) and tracer (obs/trace.py) accumulate in
memory; this module is the only place telemetry touches bytes:

  * ``prometheus_text`` renders a ``MetricsRegistry.snapshot()`` in the
    Prometheus text exposition format (``# HELP`` / ``# TYPE`` headers,
    ``name{label="v"} value`` samples, cumulative ``_bucket{le=...}`` +
    ``_sum``/``_count`` for histograms) — point any Prometheus scraper's
    textfile collector at the flushed file, or diff two snapshots directly;
  * ``parse_prometheus_text`` is the matching minimal parser — it exists so
    the exposition is ROUND-TRIP TESTED (tests/test_obs.py): every sample
    rendered must parse back to the exact value the registry held, which
    pins the format against quoting/float-formatting rot;
  * ``JsonlSink`` appends events (one JSON object per line) — the
    machine-readable stream for offline analysis, complementing the
    Perfetto trace (obs/trace.py::SpanTracer.to_chrome) meant for eyes;
  * ``PeriodicFlusher`` ties them together: call ``maybe_flush(now)`` from
    any loop and it rewrites the metrics/trace files and appends NEW trace
    events to the JSONL sink at most once per ``interval`` — observability
    of a live run without a background thread (explicit clocks again, so
    virtual-clock tests can drive flushes deterministically).
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Any, Optional

__all__ = [
    "prometheus_text",
    "parse_prometheus_text",
    "JsonlSink",
    "PeriodicFlusher",
]


def _fmt(v: float) -> str:
    """Prometheus sample value: shortest float repr that round-trips
    (integers render bare — '3' not '3.0' is what real exporters emit)."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(labels: dict, extra: Optional[tuple] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + inner + "}"


def prometheus_text(snapshot: dict) -> str:
    """Render a MetricsRegistry.snapshot() as text exposition format."""
    lines: list[str] = []
    for name, fam in snapshot.items():
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for s in fam["series"]:
            labels = s["labels"]
            if fam["kind"] == "histogram":
                acc = 0
                for le, c in zip(s["bounds"], s["counts"]):
                    acc += c
                    lines.append(
                        f"{name}_bucket{_labelstr(labels, ('le', _fmt(le)))} {acc}"
                    )
                total = acc + s["counts"][-1]
                lines.append(
                    f"{name}_bucket{_labelstr(labels, ('le', '+Inf'))} {total}"
                )
                lines.append(f"{name}_sum{_labelstr(labels)} {_fmt(s['sum'])}")
                lines.append(f"{name}_count{_labelstr(labels)} {total}")
            else:
                lines.append(f"{name}{_labelstr(labels)} {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def _parse_value(tok: str) -> float:
    return {"+Inf": math.inf, "-Inf": -math.inf, "NaN": math.nan}.get(
        tok, None
    ) if tok in ("+Inf", "-Inf", "NaN") else float(tok)


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition parser for round-trip testing.

    Returns {sample_name: {frozenset(label_items): value}} plus a ``#types``
    entry mapping family name -> declared type.  Handles exactly what
    ``prometheus_text`` emits (escaped label values included) — it is a
    test oracle, not a general scraper.
    """
    samples: dict[str, dict] = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        # name{labels} value  |  name value
        if "{" in line:
            name, rest = line.split("{", 1)
            labelpart, valpart = rest.rsplit("}", 1)
            labels = {}
            # split on '",' boundaries so escaped quotes inside values survive
            for item in labelpart.split('",'):
                item = item.rstrip('"')
                k, v = item.split('="', 1)
                labels[k] = (
                    v.replace("\\n", "\n").replace('\\"', '"')
                    .replace("\\\\", "\\")
                )
            value = valpart.strip()
        else:
            name, value = line.rsplit(None, 1)
            labels = {}
        v = _parse_value(value)
        if v is None:
            v = float(value)
        samples.setdefault(name, {})[frozenset(labels.items())] = v
    samples["#types"] = types
    return samples


class JsonlSink:
    """Append-only JSON-lines event stream (one object per line, flushed per
    write so a crashed run keeps everything already emitted)."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self.n_written = 0

    def write(self, obj: Any) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()
        self.n_written += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PeriodicFlusher:
    """Rate-limited telemetry writer for live loops.

    Call ``maybe_flush(now)`` wherever convenient (per step, per log line);
    files rewrite at most once per ``interval`` seconds of the CALLER'S
    clock.  ``close()`` force-flushes, so short runs still export.

      metrics_path   Prometheus text file (rewritten whole each flush)
      trace_path     Chrome trace JSON (rewritten whole — the ring is the
                     retention policy, the file is a view of it)
      events_path    JSONL sink appending only the trace events emitted
                     since the previous flush (ring eviction cannot lose
                     events for the sink unless more than ``capacity``
                     events arrive within one interval — ``n_dropped``
                     on the tracer says if that ever happened)
    """

    def __init__(self, *, registry=None, tracer=None, metrics_path=None,
                 trace_path=None, events_path=None, interval: float = 5.0):
        self.registry = registry
        self.tracer = tracer
        self.metrics_path = metrics_path
        self.trace_path = trace_path
        for p in (metrics_path, trace_path):
            if p:
                pathlib.Path(p).parent.mkdir(parents=True, exist_ok=True)
        self.sink = JsonlSink(events_path) if events_path else None
        self.interval = interval
        self._last: Optional[float] = None
        self._seen = 0  # tracer.n_emitted at the previous flush
        self.n_flushes = 0

    def maybe_flush(self, now: float, force: bool = False) -> bool:
        if (
            not force
            and self._last is not None
            and now - self._last < self.interval
        ):
            return False
        self._last = now
        if self.registry is not None and self.metrics_path:
            pathlib.Path(self.metrics_path).write_text(
                prometheus_text(self.registry.snapshot())
            )
        if self.tracer is not None:
            if self.trace_path:
                self.tracer.to_chrome(self.trace_path)
            if self.sink is not None:
                new = self.tracer.n_emitted - self._seen
                if new > 0:
                    ring = self.tracer.events
                    for ev in list(ring)[-min(new, len(ring)):]:
                        self.sink.write(ev)
                self._seen = self.tracer.n_emitted
        self.n_flushes += 1
        return True

    def close(self, now: float = 0.0) -> None:
        self.maybe_flush(now, force=True)
        if self.sink is not None:
            self.sink.close()
