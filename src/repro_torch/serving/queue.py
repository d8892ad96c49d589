"""Request lifecycle + arrival queue for the continuous-batching engine.

Own copy of the JAX package's ``serving/queue.py`` (plain Python and
numpy); ``percentile`` is re-exported from ``obs/stats_util.py``.

A ``Request`` moves through a small state machine with explicit failure
edges (docs/serving.md#failure-model):

  QUEUED   submitted, waiting for its arrival time AND a free slot
  PREFILL  admitted: its prompt is being scattered into a cache slot
           (models/model.py::lm_prefill_into) — transient within one
           engine.step(), which also samples the first token
  DECODE   occupying a slot; one token per engine step
  DONE     hit max_new_tokens or its eos_id; slot freed for the next request
  SHED     terminal, never admitted: the queue was at its depth limit at
           submit time (backpressure) or the request sat in-queue past its
           deadline (``arrival + ttl``).  A structured status, NOT an
           exception — load shedding is normal operation under overload.
  FAILED   terminal, admitted but quarantined: the engine detected
           non-finite logits on the request's slot (serving/engine.py) and
           its bounded retries (if any) are exhausted.

Retries: a quarantined request whose ``n_retries`` has not reached its
retry budget re-enters QUEUED with ``retry_at`` pushed out by exponential
backoff; its generated stream restarts from scratch (sampling is a pure
function of (weights, prompt, params, seed) — serving/sampler.py — so a
successful retry reproduces the fault-free stream exactly).

``RequestQueue`` is the engine-facing arrival buffer: FIFO over requests
whose ``ready_at`` time has passed (simulated-clock friendly — the engine
passes ``now`` explicitly, so tests can drive a virtual clock and the bench
can drive the wall clock), with an optional ``max_depth`` bound — a full
queue sheds at submit instead of growing without bound.
``poisson_arrivals`` builds the bench workload's arrival offsets.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Optional

import numpy as np

from ..obs.stats_util import percentile

__all__ = ["Status", "Request", "RequestQueue", "percentile", "poisson_arrivals"]


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    SHED = "shed"      # terminal: dropped in-queue (deadline / backpressure)
    FAILED = "failed"  # terminal: quarantined in-flight, retries exhausted


#: statuses from which a request will never run (again)
TERMINAL = (Status.DONE, Status.SHED, Status.FAILED)


@dataclasses.dataclass
class Request:
    """One generation request plus its engine-side bookkeeping.

    tokens: (L,) int prompt.  max_new_tokens counts EVERY generated token,
    including the one produced from the prefill logits.  temperature <= 0 is
    greedy; seed feeds the per-request PRNG stream (serving/sampler.py).
    eos_id stops generation the step it is produced (the eos token itself is
    kept in ``generated``).  patches: optional (n_patches, frontend_dim)
    prompt embeddings for VLM (frontend='patch') configs.

    ttl: seconds after ``arrival`` the request may wait UN-ADMITTED before
    it is shed (None = wait forever; the engine fills in its ``deadline``
    default at submit).  The deadline is an admission deadline measured
    from the ORIGINAL arrival — a retry re-queued past it is shed too (the
    client it would answer is presumed gone).
    max_retries: quarantine-retry budget for THIS request (None = use the
    engine default); retry_backoff seconds double per attempt.
    """

    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None
    arrival: float = 0.0
    patches: Optional[np.ndarray] = None
    ttl: Optional[float] = None
    max_retries: Optional[int] = None
    retry_backoff: float = 0.05
    # shared-prefix declaration (paged engines with prefix_cache > 0): the
    # first ``share_prefix_len`` prompt tokens are a common template whose
    # KV pages may be shared copy-on-write across requests hashing to the
    # same prefix (serving/engine.py#prefix-cache).  0 = no sharing.
    share_prefix_len: int = 0
    # engine-filled:
    status: Status = Status.QUEUED
    generated: list = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    t_admitted: Optional[float] = None  # prefill time == first-token time
    t_done: Optional[float] = None      # terminal time (DONE, SHED or FAILED)
    n_retries: int = 0
    retry_at: float = 0.0  # earliest re-admission time after a quarantine
    error: Optional[str] = None  # structured failure reason (FAILED / SHED)

    @property
    def prompt_len(self) -> int:
        return int(np.shape(self.tokens)[0])

    @property
    def ready_at(self) -> float:
        """Earliest time this request may be admitted: its arrival, pushed
        out by retry backoff after a quarantine."""
        return max(self.arrival, self.retry_at)

    @property
    def expires_at(self) -> Optional[float]:
        """Deadline for ADMISSION (None = never expires)."""
        return None if self.ttl is None else self.arrival + self.ttl

    @property
    def latency(self) -> Optional[float]:
        """Arrival -> terminal (None until the request reaches a terminal
        status with a stamped time — submit-time sheds carry no clock)."""
        return None if self.t_done is None else self.t_done - self.arrival


class RequestQueue:
    """Bounded, arrival-ordered admission buffer.

    The waiting list is kept sorted by ``ready_at`` (stable for ties, so
    equal-arrival requests admit in submission order) — submissions need NOT
    arrive pre-sorted; a request submitted after one with a later arrival
    still admits the moment its own arrival passes.

    max_depth: queue-depth limit.  ``submit`` on a full queue marks the
    request SHED and returns False instead of growing without bound —
    backpressure the caller can see.  ``requeue`` (quarantine retries) is
    exempt: a retry already holds a completed admission's worth of work.
    """

    def __init__(self, max_depth: Optional[int] = None):
        self.max_depth = max_depth
        self._waiting: list[Request] = []
        self.done: list[Request] = []  # every TERMINAL request, any status

    def submit(self, req: Request) -> bool:
        """Enqueue; False (status SHED) when the depth limit is hit."""
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        if self.max_depth is not None and len(self._waiting) >= self.max_depth:
            req.status = Status.SHED
            req.error = f"queue full (depth limit {self.max_depth})"
            self.done.append(req)
            return False
        req.status = Status.QUEUED
        bisect.insort(self._waiting, req, key=lambda r: r.ready_at)
        return True

    def requeue(self, req: Request) -> None:
        """Re-enter a quarantined request for a retry (depth-limit exempt)."""
        req.status = Status.QUEUED
        bisect.insort(self._waiting, req, key=lambda r: r.ready_at)

    def pop_ready(self, now: float) -> Optional[Request]:
        """Earliest-ready request whose ready_at has passed, else None."""
        if self._waiting and self._waiting[0].ready_at <= now:
            return self._waiting.pop(0)
        return None

    def shed_expired(self, now: float) -> list[Request]:
        """Drop every waiting request whose admission deadline has passed.

        Returns the shed requests (status SHED, t_done stamped) — the
        engine calls this at the top of every step, so a request is never
        admitted after its deadline and the queue cannot accumulate stale
        work under overload.
        """
        shed = []
        kept = []
        for r in self._waiting:
            exp = r.expires_at
            if exp is not None and now > exp:
                r.status = Status.SHED
                r.error = f"deadline: not admitted within ttl={r.ttl}s"
                r.t_done = now
                self.done.append(r)
                shed.append(r)
            else:
                kept.append(r)
        if shed:
            self._waiting = kept
        return shed

    def next_arrival(self) -> Optional[float]:
        return self._waiting[0].ready_at if self._waiting else None

    def finish(self, req: Request, now: float) -> None:
        req.status = Status.DONE
        req.t_done = now
        req.slot = None
        self.done.append(req)

    def fail(self, req: Request, now: float, error: str) -> None:
        """Terminal quarantine: retries exhausted (or disabled)."""
        req.status = Status.FAILED
        req.error = error
        req.t_done = now
        req.slot = None
        self.done.append(req)

    def __len__(self) -> int:
        return len(self._waiting)


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """(n,) cumulative arrival offsets (seconds) for a rate req/s Poisson
    process; rate <= 0 => everything arrives at t=0 (burst)."""
    if rate <= 0:
        return np.zeros(n)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))

