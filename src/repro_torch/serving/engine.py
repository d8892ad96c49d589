"""Continuous-batching serving engine of the port: per-slot decode over
recycled KV slots, contiguous or paged, with a copy-on-write prefix cache.

Port of the JAX package's ``serving/engine.py``:

  * a fixed-capacity SLOT POOL owns one batched cache
    (``models/model.py::init_caches`` at batch=capacity) for the engine's
    lifetime;
  * queued requests are admitted into free slots by a B=1 prefill written
    into the slot row (``lm_prefill_into``); prompt lengths pad to the next
    power of two (the reference's trace buckets: the same padded shapes, so
    the same flash schedules and row tiles), except under an MoE config
    (pad tokens would take expert capacity) and an xLSTM or hymba config
    (their recurrent states would integrate the pad steps), which prefill at the
    exact prompt length; the prefill logits give the request's first token, so a
    gen-N request costs N-1 decode steps;
  * all active slots step together in ONE ``lm_decode`` with per-slot
    ``pos`` and an ``active`` mask;
  * ``masks`` and the PackState are engine-level and reused by every call;
    the pack is validated at construction (``core/pack.py::validate_pack``);
  * failure edges as in the reference: depth-bounded queue and admission
    deadlines shed, a per-slot ``finite`` flag quarantines only the faulty
    request (retry with backoff or FAILED);
  * sampling per request (greedy, temperature, top-k, seed) on the
    reference's threefry streams (``serving/sampler.py``); steps whose
    active slots are all greedy take a plain argmax;
  * ``paged=True``: the KV caches are page pools (``init_paged_caches``)
    addressed through per-slot block tables of one ``BlockPool`` per cache
    group; pages are allocated at admission and returned at release;
  * ``prefix_cache=N``: an LRU table of up to N page-aligned prompt
    prefixes (sha1 of their tokens).  A hit maps the prefix pages into the
    new slot's table (refcount++; a partly shared boundary page is forked
    and copied) and prefills only the suffix (``lm_prefill_suffix``: the
    paged flash kernel K12 over the prefix).  All-global causal
    transformer configs without experts or a frontend only, as in the
    reference.  An
    xLSTM config has no KV to page: its paged engine has no pool, and its
    recurrent states stay slot-batched.  A hymba config pages its KV (a
    local ring pool and a global pool) and keeps its SSM states
    slot-batched beside them;
  * a ``patch`` config's (internvl2-1b's) request carries its prompt's
    patch embeddings (``Request.patches``, (n_patches, frontend_dim)):
    the prefill puts their rows in front of the text, so lengths, page
    counts and positions count ``n_patches`` rows more, and the text is
    bucketed as any prompt (its pads are future text positions).  An
    encoder config (``causal=False``, a ``frames`` frontend) is refused:
    it has no decode step.

The slot state (tokens, positions, active mask, sampling keys and
parameters) and the block tables have device copies that advance on the
device and are re-uploaded only when an admission or release changes the
host mirrors: a host-to-device copy synchronises the stream.

Chaos and observability, as the reference's:

  * ``faults=`` (``serving/faults.py::FaultInjector``): a planned decode
    fault's values are written into the chosen logits rows on the device
    before the finite flag and the sampler; a prefill fault replaces the
    prefill's last logits row; a prefill delay sleeps the host (wall-clock
    runs).  Without an injector the engine runs exactly the path it runs
    with none.
  * ``obs=`` (``obs.Observability``): the reference's serve_* metric
    catalog (names, kinds, labels), spans on the engine track (tid 0) and
    on each slot's (tid s + 1), and quarantine, retry, shed and
    fault_injected instants keyed by (step, rid, slot, attempt), so a trace
    joins ``quarantine_log`` and the injector's ``log`` exactly.  All of it
    is host-side: streams are identical with and without ``obs``.
  * ``stats()["n_retraces"]``: launch plans and schedules built during the
    engine's lifetime (``obs.jit_retraces``; the port has no jit).
"""
from __future__ import annotations

import hashlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.pack import publish_pack_gauges, validate_pack
from ..models.ssm import CONV_WIDTH
from ..models.model import (
    cache_group,
    init_caches,
    init_paged_caches,
    lm_decode,
    lm_prefill_into,
    lm_prefill_suffix,
    logits_all_finite,
    serving_weights,
)
from ..obs import jit_retraces, kernels_plan_caches
from ..obs.stats_util import percentile
from .block_pool import BlockPool
from .queue import Request, RequestQueue, Status
from .sampler import request_key, sample_tokens, step_keys

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


class _PrefixEntry:
    """One registered shared prefix: its page-aligned token count and the
    global-pool pages the cache holds a reference on."""

    __slots__ = ("plen", "pages")

    def __init__(self, plen: int, pages: list):
        self.plen = plen
        self.pages = pages


def _pick(logits, temp, topk, keys, greedy: bool):
    """Tokens of (B, V) logits: argmax when every row is greedy, else the
    sampler on each row's step key."""
    if greedy:
        return logits.argmax(-1)
    return sample_tokens(logits, keys, temp, topk)


class ServeEngine:
    """Fixed-capacity continuous-batching engine over one cache.

    ``params`` are the f32 masters (``init_lm``) on the serving device; the
    engine keeps a copy in the compute dtype (``serving_weights``).
    ``capacity`` is the slot count (the decode batch), ``max_len`` the
    per-slot cache length (prompt_len [+ n_patches] + max_new_tokens <=
    max_len).
    masks/pack follow the kernel-dispatch contract: with masks, every
    projection dispatches through ``cfg.sparse.kernel`` and ``pack``
    carries the block-sparse topology.  queue_limit, deadline and
    max_retries are the reference's fault-tolerance knobs; ``faults`` an
    optional ``FaultInjector``, ``obs`` an optional ``Observability``.

    Paged knobs, as the reference: ``paged`` (page pools and block tables),
    ``page_size`` (must divide max_len and each local ring length),
    ``n_blocks`` (global pool size in pages; None = capacity * max_len /
    page_size; local ring pools are always full), ``prefix_cache`` (max
    registered shared prefixes, 0 = off; needs ``paged`` and an all-global
    causal transformer).
    """

    def __init__(self, cfg, params, *, capacity: int, max_len: int,
                 masks=None, pack=None, queue_limit: Optional[int] = None,
                 deadline: Optional[float] = None, max_retries: int = 0,
                 faults=None, paged: bool = False, page_size: int = 16,
                 n_blocks: Optional[int] = None, prefix_cache: int = 0,
                 obs=None):
        if not cfg.causal:
            raise ValueError("ServeEngine needs a causal config (no decode path "
                             "for encoder-only models)")
        if cfg.frontend == "frames":
            raise ValueError("frontend='frames' has no token decode loop")
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
        self.faults = faults
        self._n_patches = cfg.n_patches if cfg.frontend == "patch" else 0
        self.queue = RequestQueue(max_depth=queue_limit)
        self.paged = paged
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        # prompt-length bucketing is exact only where end padding cannot
        # leak into state: MoE routing would let pad tokens take expert
        # capacity and xLSTM's and hymba's recurrent states would
        # integrate pad steps,
        # so those configs prefill at the exact prompt length
        self._pad_prompts = cfg.block_type == "transformer" and not cfg.n_experts
        # sharing replays nothing: every layer's cache must be plain
        # position-indexed KV with no ring wrap (no recurrent carry), and
        # admission routing-free (no MoE capacity over suffix pads); a
        # frontend's rows are not keyed by the prompt's tokens
        share_ok = (cfg.block_type == "transformer" and not cfg.n_experts
                    and cfg.frontend == "none"
                    and all(cache_group(cfg, i) == "global"
                            for i in range(cfg.n_layers)))
        if prefix_cache and not paged:
            raise ValueError("prefix_cache needs paged=True (sharing is a "
                             "property of the page tables)")
        if prefix_cache and not share_ok:
            raise ValueError(
                "prefix_cache requires an all-global transformer config without "
                "experts or a frontend (frontend='none'): a sliding-window ring "
                "cache cannot share pages, MoE routing over suffix pads is not "
                "exact, and a recurrent state cannot be shared (config "
                f"{cfg.name!r})"
            )
        self._spans: dict[str, int] = {}
        self.pools: dict[str, BlockPool] = {}
        self.tables: dict[str, np.ndarray] = {}
        self.slot_pages: list[dict[str, list]] = [{} for _ in range(capacity)]
        self._prefix_entries: dict[bytes, _PrefixEntry] = {}
        if paged:
            # one pool and one table per cache group: global layers share a
            # page id space sized in max_len rows, local ring layers a dense
            # ring pool; xLSTM has no KV to page
            for i in range(cfg.n_layers if cfg.block_type != "xlstm" else 0):
                g = cache_group(cfg, i)
                self._spans[g] = min(cfg.window, max_len) if g == "local" else max_len
            for g, span in self._spans.items():
                if span % page_size:
                    raise ValueError(f"page_size {page_size} must divide the "
                                     f"{g} cache length {span}")
                t = span // page_size
                n = capacity * t if g == "local" or n_blocks is None else n_blocks
                self.pools[g] = BlockPool(n, page_size)
                self.tables[g] = np.full((capacity, t), n, np.int32)
            self.caches = init_paged_caches(
                cfg, {g: p.n_blocks for g, p in self.pools.items()}, page_size,
                self.device, batch=capacity)
        else:
            self.caches = init_caches(cfg, capacity, max_len, self.device)
        self.n_prefix_hits = 0
        self.n_prefix_misses = 0
        # per-slot host mirrors; the decode step consumes device copies,
        # re-uploaded only when an admission or release changes a mirror
        self.active = np.zeros(capacity, bool)
        self.pos = np.zeros(capacity, np.int64)
        self.cur_tok = np.zeros(capacity, np.int64)
        self.base_keys = np.zeros((capacity, 2), np.uint32)
        self.gen_idx = np.zeros(capacity, np.int64)
        self.temp = np.zeros(capacity, np.float32)
        self.topk = np.zeros(capacity, np.int64)
        self.slot_req: list[Optional[Request]] = [None] * capacity
        self._device_state: Optional[dict] = None  # None => mirrors changed
        self._device_tables: Optional[dict] = None  # None => a table changed
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
        self.suffix_prefill_s = 0.0
        self.n_suffix_prefills = 0
        # plans built during THIS engine's lifetime (the caches are shared
        # by every engine in the process, hence the baseline)
        self._plans = kernels_plan_caches()
        self._retrace_base = jit_retraces(*self._plans)
        self.obs = obs
        self._init_obs()

    # -- observability -----------------------------------------------------

    def _init_obs(self) -> None:
        """Bind one metric-series handle per event kind, once: an enabled
        engine pays an attribute add per event.  Trace tids: 0 is the
        engine track, slot ``s`` traces on tid ``s + 1``."""
        if self.obs is None:
            self._m = None
            return
        m = self.obs.metrics
        tr = self.obs.trace
        tr.thread_name(0, "engine")
        for s in range(self.capacity):
            tr.thread_name(s + 1, f"slot{s}")
        req = m.counter("serve_requests_total",
                        "terminal requests by status", labels=("status",))
        pre = m.counter("serve_prefills_total",
                        "admissions by prefill variant", labels=("variant",))
        quar = m.counter("serve_quarantine_total",
                         "non-finite quarantines by phase", labels=("where",))
        self._m = {
            "done": req.labels("DONE"),
            "shed": req.labels("SHED"),
            "failed": req.labels("FAILED"),
            "tokens": m.counter("serve_tokens_total",
                                "tokens generated by DONE requests"),
            "steps": m.counter("serve_decode_steps_total",
                               "engine decode steps dispatched"),
            "prefill_full": pre.labels("full"),
            "prefill_suffix": pre.labels("suffix"),
            "quar_decode": quar.labels("decode"),
            "quar_prefill": quar.labels("prefill"),
            "retries": m.counter("serve_retries_total",
                                 "quarantine retries re-queued"),
            "queue_wait": m.histogram("serve_queue_wait_seconds",
                                      "ready -> admission wait"),
            "prefill_s": m.histogram("serve_prefill_seconds",
                                     "prefill dispatch wall time"),
            "step_s": m.histogram("serve_decode_step_seconds",
                                  "decode-step dispatch wall time"),
            "latency": m.histogram("serve_request_latency_seconds",
                                   "arrival -> DONE latency"),
            "slots": m.gauge("serve_slots_active", "active decode slots"),
            "depth": m.gauge("serve_queue_depth",
                             "waiting (un-admitted) requests"),
            "hit_rate": m.gauge("serve_prefix_hit_rate",
                                "prefix-cache hit fraction of probes"),
            "retraces": m.gauge(
                "serve_retraces",
                "launch plans built during this engine's lifetime"),
        }
        if self.paged:
            for nm, help_ in (("free", "free pages"), ("live", "live pages"),
                              ("forks", "copy-on-write page forks")):
                fam = m.gauge(f"serve_pool_pages_{nm}" if nm != "forks"
                              else "serve_pool_forks",
                              f"block-pool {help_}", labels=("group",))
                for g in self.pools:
                    self._m[f"pool_{nm}_{g}"] = fam.labels(g)
        # the pack is constant for the engine's lifetime: set once
        publish_pack_gauges(m, self.pack)

    def _obs_gauges(self) -> None:
        """Per-step gauge refresh: occupancy, queue depth, pool pages,
        prefix hit rate, retraces."""
        mm = self._m
        mm["slots"].set(int(self.active.sum()))
        mm["depth"].set(len(self.queue))
        probes = self.n_prefix_hits + self.n_prefix_misses
        if probes:
            mm["hit_rate"].set(self.n_prefix_hits / probes)
        mm["retraces"].set(jit_retraces(*self._plans) - self._retrace_base)
        for g, pool in self.pools.items():
            mm[f"pool_free_{g}"].set(pool.n_free)
            mm[f"pool_live_{g}"].set(pool.n_live)
            mm[f"pool_forks_{g}"].set(pool.n_forks)

    def _obs_shed(self, reqs, now: float) -> None:
        """Shed annotations (instant + counter) for queue-expired or
        backpressure-dropped requests."""
        if self._m is None or not reqs:
            return
        for r in reqs:
            self._m["shed"].inc()
            self.obs.trace.instant("shed", now, tid=0, cat="serve",
                                   args={"rid": r.rid, "reason": r.error})

    # -- admission ---------------------------------------------------------

    def _padded_len(self, prompt_len: int) -> int:
        """Next power of two, capped so the padded prompt (and its patch
        rows) fits a cache row; the exact length for an MoE or xLSTM
        config."""
        if not self._pad_prompts:
            return prompt_len
        return _chunk_capped_len(_bucket_len(prompt_len), self.max_len - self._n_patches,
                                 prompt_len, self.cfg.q_chunk)

    def submit(self, req: Request) -> bool:
        """Enqueue; False (request SHED) when the queue is full.  Invalid
        requests (oversize with the patch rows, more pages than the global
        pool, a ``patch`` config's request without patches, a hymba prompt
        under 3 tokens) raise.  Patches given to a config without a patch
        frontend are ignored, as the reference's model ignores them."""
        need = req.prompt_len + self._n_patches + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} (+{self._n_patches} "
                f"patches) + max_new_tokens {req.max_new_tokens} needs "
                f"{need} > max_len {self.max_len}"
            )
        if "global" in self.pools:
            # the paged bound is PAGES: a request the global pool could never
            # hold is rejected here rather than deferred forever
            pages = -(-need // self.page_size)
            if pages > self.pools["global"].n_blocks:
                raise ValueError(
                    f"request {req.rid}: needs {pages} KV pages "
                    f"(page_size {self.page_size}) but the global block "
                    f"pool only has {self.pools['global'].n_blocks}"
                )
        if self.cfg.frontend == "patch" and req.patches is None:
            raise ValueError(
                f"request {req.rid}: frontend='patch' configs need patches")
        if self.cfg.block_type == "hymba" and req.prompt_len < CONV_WIDTH - 1:
            # the SSM's conv state holds the prompt's last 3 inputs
            raise ValueError(
                f"request {req.rid}: a hymba prompt needs at least "
                f"{CONV_WIDTH - 1} tokens (got {req.prompt_len})")
        if req.ttl is None:
            req.ttl = self.deadline
        ok = self.queue.submit(req)
        if not ok:
            # a backpressure shed has no clock: annotate at its arrival
            self._obs_shed([req], req.arrival)
        return ok

    # -- paged-pool bookkeeping (host-side; serving/block_pool.py) ---------

    def _prefix_key(self, req: Request):
        """(key, plen) of an eligible shared-prefix probe, (None, 0) when the
        request shares nothing page-aligned: plen is the declared prefix
        floored to a page multiple, the key the sha1 of those tokens."""
        bs = self.page_size
        if not (self.prefix_cache and req.share_prefix_len >= bs):
            return None, 0
        plen = (min(req.share_prefix_len, req.prompt_len) // bs) * bs
        if plen < bs:
            return None, 0
        key = hashlib.sha1(
            np.ascontiguousarray(req.tokens[:plen], np.int32).tobytes()
        ).digest()
        return key, plen

    def _evict_prefix(self) -> None:
        """Drop the least-recently-used prefix: the cache's page references
        go; pages live slots still reference stay."""
        key = next(iter(self._prefix_entries))
        self.pools["global"].free(self._prefix_entries.pop(key).pages)

    def _ensure_free(self, want: dict) -> bool:
        """True once every group can allocate its ``want`` pages, evicting
        LRU prefixes under global-pool pressure."""
        ok = lambda: all(self.pools[g].can_alloc(n) for g, n in want.items())
        while not ok() and self._prefix_entries:
            self._evict_prefix()
        return ok()

    def _copy_page(self, src: int, dst: int) -> None:
        """Device copy-on-write: a forked global page takes the shared
        page's K/V in every layer's pool."""
        for c in self.caches:
            for leaf in c["kv"].values():
                leaf[dst].copy_(leaf[src])

    def _alloc_pages(self, req: Request, s: int) -> Optional[int]:
        """Allocate slot ``s``'s pages for ``req`` and write its table rows.

        Returns the shared-prefix length ``ctx`` (0 = full prefill), or None
        when the pools cannot hold the request even after LRU eviction (the
        caller re-queues; a release frees pages).  On a prefix hit the
        leading ``ctx // page_size`` pages are mapped (refcount++), a partly
        shared boundary page is forked and copied (or written in place when
        eviction left this slot its only holder), and only the rest is
        newly allocated.
        """
        bs = self.page_size
        need = req.prompt_len + self._n_patches + req.max_new_tokens
        want = {g: -(-min(span, need) // bs) for g, span in self._spans.items()}
        key, _ = self._prefix_key(req)
        entry = self._prefix_entries.get(key) if key is not None else None
        pool = self.pools.get("global")
        if entry is None:
            if key is not None:
                self.n_prefix_misses += 1
            if not self._ensure_free(want):
                return None
            rows = {g: self.pools[g].alloc(n) for g, n in want.items()}
            ctx = 0
        else:
            # never a zero-token suffix: the first token's logits come from
            # a real forward of at least the last prompt token
            ctx = min(entry.plen, req.prompt_len - 1)
            n_keep = ctx // bs
            boundary = ctx % bs != 0
            self._prefix_entries[key] = self._prefix_entries.pop(key)  # LRU
            shared = [int(p) for p in entry.pages[: n_keep + boundary]]
            pool.incref(shared)  # hold the pages before any eviction below
            if not self._ensure_free({"global": want["global"] - n_keep}):
                pool.free(shared)
                return None
            row = shared[:n_keep]
            n_fresh = want["global"] - n_keep
            if boundary:
                bp = shared[-1]
                if pool.refcount[bp] >= 2:  # still shared: fork and copy
                    new_bp = pool.fork(bp)
                    self._copy_page(bp, new_bp)
                    row.append(new_bp)
                else:  # eviction left it to this slot alone
                    row.append(bp)
                n_fresh -= 1
            row += pool.alloc(n_fresh)
            rows = {"global": row}
            self.n_prefix_hits += 1
        for g, pages in rows.items():
            self.tables[g][s] = self.pools[g].sentinel
            self.tables[g][s, : len(pages)] = pages
        self.slot_pages[s] = rows
        self._device_tables = None
        return ctx

    def _free_slot_pages(self, s: int) -> None:
        """Return slot ``s``'s page references (shared pages live on through
        the prefix cache's or other slots' references)."""
        for g, pages in self.slot_pages[s].items():
            self.pools[g].free(pages)
            self.tables[g][s] = self.pools[g].sentinel
        if self.slot_pages[s]:
            self.slot_pages[s] = {}
            self._device_tables = None

    def _register_prefix(self, req: Request, s: int) -> None:
        """After a finite FULL prefill: publish the request's page-aligned
        prefix pages (the cache takes its own references), evicting LRU
        entries past the limit."""
        key, plen = self._prefix_key(req)
        if key is None or key in self._prefix_entries:
            return
        pages = [int(p) for p in self.tables["global"][s][: plen // self.page_size]]
        self.pools["global"].incref(pages)
        self._prefix_entries[key] = _PrefixEntry(plen, pages)
        while len(self._prefix_entries) > self.prefix_cache:
            self._evict_prefix()

    def check_pool_accounting(self) -> None:
        """Audit every pool against the books: live pages are exactly the
        slot-table references plus the prefix-cache holds
        (``BlockPool.check``)."""
        for g, pool in self.pools.items():
            refs = [p for sp in self.slot_pages for p in sp.get(g, ())]
            if g == "global":
                for e in self._prefix_entries.values():
                    refs.extend(e.pages)
            pool.check(refs)

    def _prefill(self, req: Request, s: int, ctx: int, fval=None):
        """Run the admission prefill of ``req`` into slot ``s`` -> (first
        token, finite) on the host.  ctx > 0: only the suffix after the
        cached prefix runs (``lm_prefill_suffix``).  ``fval``: an injected
        prefill fault, written over the last logits row before the finite
        flag and the pick."""
        dev = self.device
        slen = req.prompt_len - ctx
        padded = self._padded_len(slen)
        toks = np.zeros(padded, np.int64)
        toks[:slen] = req.tokens[ctx:]
        batch = {"tokens": torch.from_numpy(toks)[None].to(dev)}
        if self._n_patches:
            batch["patches"] = torch.from_numpy(
                np.asarray(req.patches, np.float32))[None].to(dev)
        tables = ({g: torch.from_numpy(t[s]).to(dev) for g, t in self.tables.items()}
                  if self.paged else None)
        if ctx:
            logits, self.caches = lm_prefill_suffix(
                self.params, self.cfg, self.caches, batch, tables["global"],
                ctx, masks=self.masks, pack=self.pack, n_valid=slen)
        else:
            logits, self.caches = lm_prefill_into(
                self.params, self.cfg, self.caches, batch, s, self.max_len,
                masks=self.masks, pack=self.pack, n_valid=slen + self._n_patches,
                tables=tables)
        last = logits[:, -1]
        if fval is not None:
            last = torch.full_like(last, fval)
        greedy = req.temperature <= 0.0
        keys = None if greedy else step_keys(
            torch.from_numpy(request_key(req.seed)[None].astype(np.int64)).to(dev),
            torch.zeros(1, dtype=torch.int64, device=dev))
        tok = _pick(last, torch.full((1,), req.temperature, device=dev),
                    torch.full((1,), req.top_k, device=dev), keys, greedy)
        tok, fin = (int(x) for x in torch.stack(
            [tok[0], logits_all_finite(last)[0].long()]).cpu())
        return tok, bool(fin)

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
            ctx = 0
            if self.paged:
                got = self._alloc_pages(req, s)
                if got is None:
                    # pools exhausted by outstanding slots: hand the request
                    # back; a release frees pages and a later step retries
                    self.queue.requeue(req)
                    return
                ctx = got
            fval = None
            if self.faults is not None:
                fval = self.faults.prefill_fault(req.rid, req.n_retries)
                if clock is not None:
                    delay = self.faults.prefill_delay(req.rid)
                    if delay > 0:
                        time.sleep(delay)  # wall-clock chaos only (run())
            ts = clock() if clock is not None else now
            t0 = time.perf_counter()
            tok, fin = self._prefill(req, s, ctx, fval)
            dt = time.perf_counter() - t0
            self.prefill_s += dt
            self.n_prefills += 1
            if ctx:
                self.suffix_prefill_s += dt
                self.n_suffix_prefills += 1
            t = clock() if clock is not None else now
            if self._m is not None:
                tid = s + 1
                self.obs.trace.span(
                    "queue_wait", req.ready_at, ts, tid=tid, cat="serve",
                    args={"rid": req.rid, "attempt": req.n_retries})
                self.obs.trace.span(
                    "prefill", ts, t, tid=tid, cat="serve",
                    args={"rid": req.rid, "attempt": req.n_retries,
                          "variant": "suffix" if ctx else "full",
                          "padded_len": self._padded_len(req.prompt_len - ctx),
                          "slot": s})
                self._m["queue_wait"].observe(max(ts - req.ready_at, 0.0))
                self._m["prefill_s"].observe(max(t - ts, 0.0))
                self._m["prefill_suffix" if ctx else "prefill_full"].inc()
            if not fin:
                self._quarantine(req, s, t, finished, where="prefill")
                continue
            if self.paged and not ctx:
                # publish the finite-verified prefix pages for reuse
                self._register_prefix(req, s)
            req.generated.append(tok)
            req.slot = s
            req.status = Status.DECODE
            req.t_admitted = t
            self.slot_history.append((req.rid, s))
            self.slot_req[s] = req
            self.active[s] = True
            self.pos[s] = req.prompt_len + self._n_patches
            self.cur_tok[s] = tok
            self.base_keys[s] = request_key(req.seed)
            self.gen_idx[s] = 1
            self.temp[s] = req.temperature
            self.topk[s] = req.top_k
            self._device_state = None
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
        if self.paged:
            self._free_slot_pages(s)
        self.active[s] = False
        self.slot_req[s] = None
        self._device_state = None
        if self._m is not None:
            self._m["done"].inc()
            self._m["tokens"].inc(len(req.generated))
            if req.latency is not None:
                self._m["latency"].observe(req.latency)
            # the request's decode residency on its slot's track
            self.obs.trace.span(
                "decode", req.t_admitted, now, tid=s + 1, cat="serve",
                args={"rid": req.rid, "n_tokens": len(req.generated)})

    def _quarantine(self, req: Request, slot: int, now: float,
                    finished: list, *, where: str) -> None:
        """Non-finite logits on ``req``'s slot: drop the token, free the slot
        and its pages (the next admission overwrites the row), then
        re-queue with exponential backoff or land the request FAILED."""
        self.n_quarantined += 1
        self.quarantine_log.append(
            QuarantineRecord(self.n_steps, req.rid, slot, req.n_retries, where)
        )
        if self._m is not None:
            self._m["quar_decode" if where == "decode" else "quar_prefill"].inc()
            self.obs.trace.instant(
                "quarantine", now, tid=slot + 1, cat="chaos",
                args={"step": self.n_steps, "rid": req.rid, "slot": slot,
                      "attempt": req.n_retries, "where": where})
        if self.paged:
            self._free_slot_pages(slot)
        self.active[slot] = False
        self.slot_req[slot] = None
        self._device_state = None
        limit = self.max_retries if req.max_retries is None else req.max_retries
        if req.n_retries < limit:
            req.n_retries += 1
            self.n_retries_total += 1
            req.generated = []
            req.slot = None
            req.t_admitted = None
            req.retry_at = now + req.retry_backoff * (2 ** (req.n_retries - 1))
            self.queue.requeue(req)
            if self._m is not None:
                self._m["retries"].inc()
                self.obs.trace.instant(
                    "retry", now, tid=0, cat="chaos",
                    args={"rid": req.rid, "attempt": req.n_retries,
                          "retry_at": req.retry_at})
        else:
            self.queue.fail(
                req, now,
                f"non-finite logits during {where} "
                f"(after {req.n_retries} retries)",
            )
            finished.append(req)
            if self._m is not None:
                self._m["failed"].inc()

    # -- stepping ----------------------------------------------------------

    def _device_carry(self) -> dict:
        """Device copies of the slot mirrors and tables, uploaded when a
        mirror changed since the last step."""
        dev = self.device
        if self._device_state is None:
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            self._device_state = {
                "tok": up(self.cur_tok[:, None]), "pos": up(self.pos),
                "active": up(self.active),
                "keys": up(self.base_keys.astype(np.int64)),
                "gen": up(self.gen_idx), "temp": up(self.temp),
                "topk": up(self.topk),
            }
        if self.paged and self._device_tables is None:
            self._device_tables = {g: torch.from_numpy(t).to(dev)
                                   for g, t in self.tables.items()}
        return self._device_state

    def step(self, now: float = 0.0, clock=None) -> list[Request]:
        """Shed expired queue entries, admit what fits, then decode one
        token on every active slot.  Returns the requests that reached a
        terminal status during this step."""
        finished: list[Request] = []
        shed = self.queue.shed_expired(now)
        finished.extend(shed)
        self._obs_shed(shed, now)
        self._admit(now, finished, clock)
        if not self.active.any():
            if self._m is not None:
                self._obs_gauges()
            return finished
        ts = clock() if clock is not None else now
        t0 = time.perf_counter()
        fault = (self.faults.decode_fault(self.n_steps, self.capacity)
                 if self.faults is not None else None)
        if fault is not None and self._m is not None:
            # the TARGETED slots that are active (with the request each
            # holds): the exact expected-quarantine set of this step
            hit = [{"slot": int(s2), "rid": self.slot_req[s2].rid,
                    "attempt": self.slot_req[s2].n_retries}
                   for s2 in np.nonzero(fault[0])[0] if self.active[s2]]
            self.obs.trace.instant(
                "fault_injected", now, tid=0, cat="chaos",
                args={"step": self.n_steps,
                      "targeted": [int(x) for x in np.nonzero(fault[0])[0]],
                      "active": hit})
        st = self._device_carry()
        logits, self.caches = lm_decode(
            self.params, self.cfg, self.caches, st["tok"], st["pos"],
            masks=self.masks, pack=self.pack, active=st["active"],
            tables=self._device_tables if self.paged else None,
        )
        last = logits[:, -1]
        if fault is not None:
            fmask, fval = (torch.from_numpy(a).to(self.device) for a in fault)
            last = torch.where(fmask[:, None], fval[:, None].to(last.dtype), last)
        # all-greedy steps skip the sampler (no (B, V) sort, no noise)
        greedy = not bool(np.any(self.temp[self.active] > 0.0))
        keys = None if greedy else step_keys(st["keys"], st["gen"])
        nxt = _pick(last, st["temp"], st["topk"], keys, greedy)
        act = st["active"]
        st["tok"] = torch.where(act[:, None], nxt[:, None], st["tok"])
        st["pos"] = st["pos"] + act
        st["gen"] = st["gen"] + act
        out = torch.stack([nxt, logits_all_finite(last).long()]).cpu()
        nxt, finite = out[0].numpy(), out[1].numpy().astype(bool)
        self.decode_s += time.perf_counter() - t0
        t = clock() if clock is not None else now
        if self._m is not None:
            self.obs.trace.span(
                "decode_step", ts, t, tid=0, cat="serve",
                args={"step": self.n_steps, "n_active": int(self.active.sum()),
                      "greedy": bool(greedy)})
            self._m["step_s"].observe(max(t - ts, 0.0))
            self._m["steps"].inc()
        for s in np.nonzero(self.active)[0]:
            req = self.slot_req[s]
            if not finite[s]:
                self._quarantine(req, int(s), t, finished, where="decode")
                continue
            tok = int(nxt[s])
            req.generated.append(tok)
            self.pos[s] += 1
            self.gen_idx[s] += 1
            self.cur_tok[s] = tok
            if self._is_finished(req, tok):
                self._release(req, t)
                finished.append(req)
        # counted AFTER the host loop, so quarantine_log records the step
        # index the injector keyed this step's fault on
        self.n_steps += 1
        if self._m is not None:
            self._obs_gauges()
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
        """Aggregate summary: the reference's keys (``n_retraces`` counts
        the launch plans built during the engine's lifetime), plus the
        host-clock prefill totals (all, and suffix-only admissions) and the
        mean decode-step time."""
        by = lambda st: [r for r in self.queue.done if r.status is st]
        done = by(Status.DONE)
        toks = sum(len(r.generated) for r in done)
        lat = [r.latency for r in done if r.latency is not None]
        waits = [r.t_admitted - r.arrival for r in self.queue.done
                 if r.t_admitted is not None]
        out = {
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
            "suffix_prefills": self.n_suffix_prefills,
            "suffix_prefill_s": self.suffix_prefill_s,
            "n_retraces": jit_retraces(*self._plans) - self._retrace_base,
        }
        if self.paged:
            out["prefix_hits"] = self.n_prefix_hits
            out["prefix_misses"] = self.n_prefix_misses
            out["prefix_entries"] = len(self._prefix_entries)
            out["kv_forks"] = sum(p.n_forks for p in self.pools.values())
            out["pages_free"] = {g: p.n_free for g, p in self.pools.items()}
            out["pages_live"] = {g: p.n_live for g, p in self.pools.items()}
        return out
