"""Continuous-batching serving engine of the port: per-slot greedy decode
over recycled KV slots.

Port of the JAX package's ``serving/engine.py`` for the contiguous cache
layout and greedy decoding:

  * a fixed-capacity SLOT POOL owns one batched cache
    (``models/model.py::init_caches`` at batch=capacity) for the engine's
    lifetime;
  * queued requests are admitted into free slots by a B=1 prefill written
    into the slot row (``lm_prefill_into``); prompt lengths pad to the next
    power of two (the reference's trace buckets: the same padded shapes, so
    the same flash schedules and row tiles), and the prefill logits give the
    request's first token, so a gen-N request costs N-1 decode steps;
  * all active slots step together in ONE ``lm_decode`` with per-slot
    ``pos`` and an ``active`` mask;
  * ``masks`` and the PackState are engine-level and reused by every call;
    the pack is validated at construction (``core/pack.py::validate_pack``);
  * failure edges as in the reference: depth-bounded queue and admission
    deadlines shed, a per-slot ``finite`` flag quarantines only the faulty
    request (retry with backoff or FAILED).

Not ported yet (raise ``NotImplementedError``): paged caches and the prefix
cache, the fault injector, observability hooks, and temperature/top-k
sampling, whose reference streams are ``jax.random`` threefry keys.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.pack import validate_pack
from ..models.model import (
    init_caches,
    lm_decode,
    lm_prefill_into,
    logits_all_finite,
    serving_weights,
)
from .queue import Request, RequestQueue, Status, percentile

__all__ = ["ServeEngine", "QuarantineRecord"]


class QuarantineRecord(NamedTuple):
    """One quarantine event: engine decode step at detection, request,
    slot, retry ordinal (0 = first admission) and phase."""

    step: int
    rid: int
    slot: int
    attempt: int
    where: str  # "decode" | "prefill"


def _bucket_len(n: int, floor: int = 8) -> int:
    """Next power of two >= n (with a small floor)."""
    return max(floor, 1 << (n - 1).bit_length())


def _chunk_capped_len(bucket: int, cap: int, length: int, q_chunk: int) -> int:
    """min(bucket, cap), except a CAPPING cap is rounded down to the
    q-chunk multiple when that still covers ``length`` (as the reference)."""
    if bucket <= cap:
        return bucket
    if q_chunk:
        aligned = (cap // q_chunk) * q_chunk
        if aligned >= length:
            return aligned
    return cap


def _not_ported(what: str):
    return NotImplementedError(f"ServeEngine: {what} is not ported yet")


class ServeEngine:
    """Fixed-capacity continuous-batching engine over one cache.

    ``params`` are the f32 masters (``init_lm``) on the serving device; the
    engine keeps a copy in the compute dtype (``serving_weights``).
    ``capacity`` is the slot count (the decode batch), ``max_len`` the
    per-slot cache length (prompt_len + max_new_tokens <= max_len).
    masks/pack follow the kernel-dispatch contract: with masks, every
    projection dispatches through ``cfg.sparse.kernel`` and ``pack``
    carries the block-sparse topology.  queue_limit, deadline and
    max_retries are the reference's fault-tolerance knobs.
    """

    def __init__(self, cfg, params, *, capacity: int, max_len: int,
                 masks=None, pack=None, queue_limit: Optional[int] = None,
                 deadline: Optional[float] = None, max_retries: int = 0,
                 faults=None, paged: bool = False, page_size: int = 16,
                 n_blocks: Optional[int] = None, prefix_cache: int = 0,
                 obs=None):
        if faults is not None:
            raise _not_ported("fault injection (faults=)")
        if paged or prefix_cache:
            raise _not_ported("the paged KV cache and prefix cache")
        if obs is not None:
            raise _not_ported("observability (obs=)")
        if not cfg.causal:
            raise ValueError("ServeEngine needs a causal config")
        self.cfg = cfg
        self.masks = masks
        self.pack = pack
        # integrity guard: a corrupted pack would make every kernel of every
        # request execute the wrong topology — fail at construction, loudly
        validate_pack(pack, where="ServeEngine.pack")
        self.params = serving_weights(params, cfg)
        self.device = self.params["embed"]["table"].device
        self.capacity = capacity
        self.max_len = max_len
        self.deadline = deadline
        self.max_retries = max_retries
        self.queue = RequestQueue(max_depth=queue_limit)
        self.caches = init_caches(cfg, capacity, max_len, self.device)
        self.active = np.zeros(capacity, bool)
        self.pos = np.zeros(capacity, np.int64)
        self.cur_tok = np.zeros(capacity, np.int64)
        self.slot_req: list[Optional[Request]] = [None] * capacity
        self.n_steps = 0
        self.n_prefills = 0
        self.n_quarantined = 0
        self.n_retries_total = 0
        self.slot_history: list[tuple[int, int]] = []  # (rid, slot) admissions
        self.quarantine_log: list[QuarantineRecord] = []
        # host-clock seconds spent in prefills and decode steps; each ends in
        # a device-to-host copy, so they include the device work
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # -- admission ---------------------------------------------------------

    def _padded_len(self, prompt_len: int) -> int:
        """Next power of two, capped so the padded prompt fits a cache row."""
        return _chunk_capped_len(_bucket_len(prompt_len), self.max_len,
                                 prompt_len, self.cfg.q_chunk)

    def submit(self, req: Request) -> bool:
        """Enqueue; False (request SHED) when the queue is full.  Invalid
        requests (oversize, max_new_tokens < 1, sampling) raise."""
        need = req.prompt_len + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new_tokens "
                f"{req.max_new_tokens} needs {need} > max_len {self.max_len}"
            )
        if req.temperature > 0.0 or req.top_k:
            raise _not_ported("temperature/top-k sampling (greedy only)")
        if req.share_prefix_len or req.patches is not None:
            raise _not_ported("shared prefixes and patch prompts")
        if req.ttl is None:
            req.ttl = self.deadline
        return self.queue.submit(req)

    def _admit(self, now: float, finished: list, clock=None) -> None:
        while True:
            free = np.nonzero(~self.active)[0]
            if len(free) == 0:
                return
            req = self.queue.pop_ready(now)
            if req is None:
                return
            s = int(free[0])
            req.status = Status.PREFILL
            padded = self._padded_len(req.prompt_len)
            toks = np.zeros(padded, np.int64)
            toks[: req.prompt_len] = req.tokens
            batch = {"tokens": torch.from_numpy(toks)[None].to(self.device)}
            t0 = time.perf_counter()
            logits, self.caches = lm_prefill_into(
                self.params, self.cfg, self.caches, batch, s, self.max_len,
                masks=self.masks, pack=self.pack,
                n_valid=req.prompt_len,
            )
            last = logits[0, -1]
            tok, fin = (int(x) for x in torch.stack(
                [last.argmax(), torch.isfinite(last).all().long()]).cpu())
            self.prefill_s += time.perf_counter() - t0
            self.n_prefills += 1
            t = clock() if clock is not None else now
            if not fin:
                self._quarantine(req, s, t, finished, where="prefill")
                continue
            req.generated.append(tok)
            req.slot = s
            req.status = Status.DECODE
            req.t_admitted = t
            self.slot_history.append((req.rid, s))
            self.slot_req[s] = req
            self.active[s] = True
            self.pos[s] = req.prompt_len
            self.cur_tok[s] = tok
            if self._is_finished(req, tok):
                self._release(req, t)
                finished.append(req)

    def _is_finished(self, req: Request, tok: int) -> bool:
        return len(req.generated) >= req.max_new_tokens or (
            req.eos_id is not None and tok == req.eos_id
        )

    def _release(self, req: Request, now: float) -> None:
        s = req.slot
        self.queue.finish(req, now)
        self.active[s] = False
        self.slot_req[s] = None

    def _quarantine(self, req: Request, slot: int, now: float,
                    finished: list, *, where: str) -> None:
        """Non-finite logits on ``req``'s slot: drop the token, free the slot
        (the next admission overwrites the row), then re-queue with
        exponential backoff or land the request FAILED."""
        self.n_quarantined += 1
        self.quarantine_log.append(
            QuarantineRecord(self.n_steps, req.rid, slot, req.n_retries, where)
        )
        self.active[slot] = False
        self.slot_req[slot] = None
        limit = self.max_retries if req.max_retries is None else req.max_retries
        if req.n_retries < limit:
            req.n_retries += 1
            self.n_retries_total += 1
            req.generated = []
            req.slot = None
            req.t_admitted = None
            req.retry_at = now + req.retry_backoff * (2 ** (req.n_retries - 1))
            self.queue.requeue(req)
        else:
            self.queue.fail(
                req, now,
                f"non-finite logits during {where} "
                f"(after {req.n_retries} retries)",
            )
            finished.append(req)

    # -- stepping ----------------------------------------------------------

    def step(self, now: float = 0.0, clock=None) -> list[Request]:
        """Shed expired queue entries, admit what fits, then decode one
        token on every active slot.  Returns the requests that reached a
        terminal status during this step."""
        finished: list[Request] = []
        finished.extend(self.queue.shed_expired(now))
        self._admit(now, finished, clock)
        if not self.active.any():
            return finished
        dev = self.device
        t0 = time.perf_counter()
        logits, self.caches = lm_decode(
            self.params, self.cfg, self.caches,
            torch.from_numpy(self.cur_tok[:, None]).to(dev),
            torch.from_numpy(self.pos).to(dev),
            masks=self.masks, pack=self.pack,
            active=torch.from_numpy(self.active).to(dev),
        )
        last = logits[:, -1]
        out = torch.stack([last.argmax(-1), logits_all_finite(last).long()]).cpu()
        nxt, finite = out[0].numpy(), out[1].numpy().astype(bool)
        self.decode_s += time.perf_counter() - t0
        t = clock() if clock is not None else now
        for s in np.nonzero(self.active)[0]:
            req = self.slot_req[s]
            if not finite[s]:
                self._quarantine(req, int(s), t, finished, where="decode")
                continue
            tok = int(nxt[s])
            req.generated.append(tok)
            self.pos[s] += 1
            self.cur_tok[s] = tok
            if self._is_finished(req, tok):
                self._release(req, t)
                finished.append(req)
        self.n_steps += 1
        return finished

    def run(self) -> dict:
        """Drive until the queue drains; request ``arrival`` values are
        offsets from this call.  Returns ``stats``."""
        t0 = time.monotonic()
        clock = lambda: time.monotonic() - t0
        while len(self.queue) or self.active.any():
            self.step(clock(), clock)
            if not self.active.any() and len(self.queue):
                nxt = self.queue.next_arrival()
                if nxt is not None:
                    wait = nxt - clock()
                    if wait > 0:
                        time.sleep(wait)
        return self.stats(clock())

    def stats(self, wall_s: float) -> dict:
        """Aggregate summary: the reference's keys, minus its jit retrace
        count (the port compiles nothing per shape), plus the host-clock
        prefill total and mean decode-step time."""
        by = lambda st: [r for r in self.queue.done if r.status is st]
        done = by(Status.DONE)
        toks = sum(len(r.generated) for r in done)
        lat = [r.latency for r in done if r.latency is not None]
        waits = [r.t_admitted - r.arrival for r in self.queue.done
                 if r.t_admitted is not None]
        return {
            "requests": len(done),
            "shed": len(by(Status.SHED)),
            "failed": len(by(Status.FAILED)),
            "quarantined": self.n_quarantined,
            "retries": self.n_retries_total,
            "tokens": toks,
            "wall_s": wall_s,
            "tok_per_s": toks / max(wall_s, 1e-9),
            "decode_steps": self.n_steps,
            "prefills": self.n_prefills,
            "prefill_s": self.prefill_s,
            "decode_step_s": self.decode_s / max(self.n_steps, 1),
            "latency_p50_s": percentile(lat, 50),
            "latency_p95_s": percentile(lat, 95),
            "queue_wait_p50_s": percentile(waits, 50),
            "queue_wait_p95_s": percentile(waits, 95),
        }
