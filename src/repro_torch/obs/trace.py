"""Span tracer emitting Chrome Trace Event Format (Perfetto-loadable) JSON.

One ``SpanTracer`` collects the per-request / per-step timeline the aggregate
counters cannot show: where a request's lifetime went (queue wait vs prefill
vs decode), which step a quarantine fired on, when the trainer's topology
updates landed.  The output is the Chrome Trace Event Format's JSON-object
form — ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` — which both
Perfetto (ui.perfetto.dev, drag-and-drop) and chrome://tracing open directly
(docs/observability.md#opening-a-trace).

Design constraints, in order:

  * **explicit clocks** — every emit takes caller-provided timestamps in
    SECONDS.  The serving engine runs under a virtual clock in tests and the
    wall clock in production (serving/engine.py::ServeEngine.step passes its
    ``now``/``clock`` straight through), so the tracer must never read time
    itself: two identical seeded virtual-clock runs emit bit-identical
    traces, which is what makes traces assertable (tests/test_obs.py) and
    not just viewable.  Timestamps are stored as integer microseconds (the
    format's native unit).
  * **bounded memory** — events land in a ring buffer (``capacity`` events);
    a week-long serve loop cannot OOM the host through its own telemetry.
    Evictions are COUNTED (``n_dropped``) and oldest-first, so a truncated
    trace is still a correct suffix of the run.  Process/thread-name
    metadata events live OUTSIDE the ring: truncation never drops the
    labels that make the remaining events readable.
  * **cheap emits** — an emit is one small dict build + deque append; no
    string formatting, no I/O.  Serialization happens only at flush/export
    time (obs/export.py), never on the hot path.

Event vocabulary used by this repo's instrumentation (the span taxonomy
table in docs/observability.md#span-taxonomy): ``ph="X"`` complete spans
(queue_wait / prefill / decode / decode_step / train_step), ``ph="i"``
instants (quarantine / shed / fault_injected / topology_update), ``ph="C"``
counter tracks (loss, slot occupancy) and ``ph="M"`` metadata names.
"""
from __future__ import annotations

import json
import pathlib
from collections import deque
from typing import Any, Optional

__all__ = ["SpanTracer"]


def _us(t: float) -> int:
    """Seconds -> integer microseconds (the trace format's time unit)."""
    return int(round(t * 1e6))


class SpanTracer:
    """Bounded ring of Chrome trace events with explicit-clock emits.

    capacity       ring size in events; the oldest event is dropped (and
                   ``n_dropped`` incremented) once full
    pid            process id stamped on every event — instrumented
                   subsystems in one process use distinct pids so Perfetto
                   groups their tracks (serve=0 by convention, train=1)
    process_name   optional ``process_name`` metadata row
    """

    def __init__(self, capacity: int = 65536, pid: int = 0,
                 process_name: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"SpanTracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.pid = pid
        self.events: deque = deque(maxlen=capacity)
        self._meta: list[dict] = []  # name metadata, exempt from the ring
        self.n_emitted = 0  # lifetime emits (ring length + n_dropped)
        self.n_dropped = 0
        self._named_tids: set[int] = set()
        if process_name is not None:
            self._meta.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": process_name},
            })

    # -- naming ------------------------------------------------------------

    def thread_name(self, tid: int, name: str) -> None:
        """Label a tid's track (idempotent per tid — first name wins, so hot
        paths may call this unconditionally)."""
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._meta.append({
            "ph": "M", "name": "thread_name", "pid": self.pid, "tid": tid,
            "args": {"name": name},
        })

    # -- emits (hot path: one dict + one append) ---------------------------

    def _push(self, ev: dict) -> None:
        if len(self.events) == self.capacity:
            self.n_dropped += 1
        self.events.append(ev)
        self.n_emitted += 1

    def span(self, name: str, t0: float, t1: float, *, tid: int = 0,
             cat: str = "", args: Optional[dict] = None) -> None:
        """Complete span [t0, t1] (seconds) — ``ph="X"`` with a duration, the
        cheapest span form (no begin/end pairing for the viewer to repair)."""
        ev: dict[str, Any] = {
            "ph": "X", "name": name, "cat": cat, "pid": self.pid, "tid": tid,
            "ts": _us(t0), "dur": max(_us(t1) - _us(t0), 0),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, ts: float, *, tid: int = 0, cat: str = "",
                args: Optional[dict] = None) -> None:
        """Thread-scoped instant marker (``ph="i"``) — annotations like
        quarantine/shed that have a moment, not an extent."""
        ev: dict[str, Any] = {
            "ph": "i", "s": "t", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": _us(ts),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, ts: float, values: dict, *,
                tid: int = 0) -> None:
        """Counter-track sample (``ph="C"``): Perfetto renders each key of
        ``values`` as a stacked series — the live loss / occupancy strips."""
        self._push({
            "ph": "C", "name": name, "pid": self.pid, "tid": tid,
            "ts": _us(ts), "args": dict(values),
        })

    # -- export ------------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Metadata + ring contents, oldest first (metadata leads so viewers
        see names before the events that use them)."""
        return self._meta + list(self.events)

    def to_chrome(self, path) -> None:
        """Write the JSON-object trace form Perfetto/chrome://tracing load."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": self.chrome_events(),
                 "displayTimeUnit": "ms"},
                f,
            )

    def find(self, name: str) -> list[dict]:
        """Events (ring order) with a given name — the test/bench helper for
        cross-checking emitted annotations against ground truth (e.g.
        quarantine instants vs FaultInjector.log)."""
        return [e for e in self.events if e.get("name") == name]
