"""Deterministic fault injection for chaos-testing the port's serving
engine.

Port of the JAX package's ``serving/faults.py``: ``FaultInjector`` plans
faults ahead of time (seeded, reproducible: the same plan, the same run;
the same ``np.random.default_rng`` schedule and the same ``log`` tuples as
the reference's) and ``ServeEngine`` consults it at its hook points:

  * **decode logits corruption** — ``poison_logits(step, slot)`` marks a
    (decode-step, slot) pair; at that step the engine writes the value into
    that slot's logits row on the device, *before* the finite flag and the
    sampler (so detection sees exactly what a real non-finite forward would
    produce).  Every other row is untouched (a per-row ``torch.where``),
    which is what makes the chaos isolation invariant testable: unaffected
    requests are token-identical to a fault-free run.
  * **prefill corruption / delay** — ``poison_prefill(rid)`` corrupts the
    prefill logits of every admission attempt of that request (retry
    exhaustion); ``delay_prefill(rid, seconds)`` sleeps the host before the
    prefill (wall-clock runs only), building queue backlog so deadline
    shedding triggers.

Pack corruption (``truncate_pack``) and burst arrival storms
(``burst_storm``) are module functions: the pack guard fires at engine
construction (``core/pack.py::validate_pack``), and a storm is just a
workload.  An engine without an injector runs exactly the code path it
runs with none attached.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.masks import tree_map
from ..core.pack import is_pack_entry, pack_entries
from .queue import Request

__all__ = ["FaultInjector", "truncate_pack", "burst_storm"]

NAN = float("nan")
INF = float("inf")


class FaultInjector:
    """Seeded, pre-planned fault schedule consumed by ``ServeEngine`` hooks.

    All scheduling is host-side and deterministic: the engine's decode-step
    counter (``ServeEngine.n_steps``) keys decode faults, request rids key
    prefill faults — under a virtual clock the same workload replays the
    same faults at the same points, which the isolation tests rely on.
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._decode: dict[int, dict[int, float]] = {}   # step -> {slot: val}
        self._prefill: dict[int, float] = {}             # rid -> value
        self._delays: dict[int, float] = {}              # rid -> seconds
        self.log: list[tuple] = []  # (kind, key, detail) of FIRED injections

    # -- planning ----------------------------------------------------------

    def poison_logits(self, step: int, slot: int, value: float = NAN) -> "FaultInjector":
        """Corrupt ``slot``'s logits row to ``value`` at decode step ``step``
        (engine-global step counter).  A pair targeting an inactive slot is
        a no-op (parked slots' logits are garbage by design and never read).
        Returns self for chaining."""
        self._decode.setdefault(int(step), {})[int(slot)] = float(value)
        return self

    def poison_random(self, n: int, *, max_step: int, capacity: int,
                      value: float = NAN) -> list[tuple[int, int]]:
        """Schedule ``n`` seeded-random (step, slot) poisonings; returns the
        chosen pairs so tests/benches know what was planned."""
        pairs = []
        while len(pairs) < n:
            step = int(self.rng.integers(0, max_step))
            slot = int(self.rng.integers(0, capacity))
            if self._decode.get(step, {}).get(slot) is None:
                self.poison_logits(step, slot, value)
                pairs.append((step, slot))
        return pairs

    def poison_prefill(self, rid: int, value: float = NAN) -> "FaultInjector":
        """Corrupt the prefill logits of EVERY admission attempt of request
        ``rid`` — the way to drive a request through retry exhaustion."""
        self._prefill[int(rid)] = float(value)
        return self

    def delay_prefill(self, rid: int, seconds: float) -> "FaultInjector":
        """Host-sleep before ``rid``'s prefill (wall-clock runs only —
        virtual-clock tests model delay by advancing ``now`` instead)."""
        self._delays[int(rid)] = float(seconds)
        return self

    # -- engine-facing hooks ----------------------------------------------

    def decode_fault(self, step: int, capacity: int):
        """(mask (B,) bool, values (B,) f32) for this step, or None."""
        plan = self._decode.get(int(step))
        if not plan:
            return None
        mask = np.zeros(capacity, bool)
        vals = np.zeros(capacity, np.float32)
        for slot, v in plan.items():
            if 0 <= slot < capacity:
                mask[slot] = True
                vals[slot] = v
        if not mask.any():
            return None
        self.log.append(("decode", int(step), tuple(sorted(plan))))
        return mask, vals

    def prefill_fault(self, rid: int, attempt: int = 0) -> Optional[float]:
        """``attempt`` is the request's retry ordinal (0 = first admission):
        logged alongside the rid so a retried-then-poisoned-again request's
        fired entries are distinguishable — the engine's quarantine records
        carry the same (rid, attempt) pair, making the trace <-> injector
        correlation exact."""
        v = self._prefill.get(int(rid))
        if v is not None:
            self.log.append(("prefill", int(rid), int(attempt), v))
        return v

    def prefill_delay(self, rid: int) -> float:
        return self._delays.get(int(rid), 0.0)


def truncate_pack(pack, *, mode: str = "truncate", seed: int = 0):
    """Return a corrupted copy of a PackState tree (``core/pack.py``); the
    caller's pack is never mutated.

    Corruption lands on the first packed entry (deterministic; ``seed``
    picks the column of ``oob``), as the reference's:

      truncate   chop the trailing CSC (and CSR) width column while leaving
                 ``cnt`` claiming the old width — the kernel would read past
                 the packed index rows
      oob        write an out-of-range K-block id into a live CSC slot — the
                 kernel would read a block that does not exist
      nnz        break the count/nnz consistency (the cnt sum no longer
                 equals the recorded total) — silent topology drift

    ``validate_pack`` turns each of these into a loud PackIntegrityError.
    """
    pack = tree_map(
        lambda _, e: None if e is None else {
            k: v.clone() if torch.is_tensor(v) else v for k, v in e.items()},
        pack, is_leaf=is_pack_entry)
    rng = np.random.default_rng(seed)
    entry = next(e for _, e in pack_entries(pack) if "idx" in e)
    idx, cnt = entry["idx"], entry["cnt"]
    if mode == "truncate":
        entry["idx"] = idx[..., :-1].contiguous()
        entry["ridx"] = entry["ridx"][..., :-1].contiguous()
        # cnt/rcnt left claiming the old width: counts now exceed capacity
    elif mode == "oob":
        col = int(rng.integers(0, cnt.shape[-1]))
        live_cols = torch.nonzero(cnt.reshape(-1) > 0).flatten().tolist()
        col = live_cols[col % len(live_cols)]
        idx2 = idx.reshape(-1, idx.shape[-1]).clone()
        idx2[col, 0] = int(entry["nkb"]) + 3  # past the K-block grid
        entry["idx"] = idx2.reshape(idx.shape)
    elif mode == "nnz":
        entry["nnz"] = int(entry["nnz"]) + 1
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return pack


def burst_storm(cfg, n: int, *, at: float = 0.0, prompt_len: int = 8,
                max_new_tokens: int = 8, ttl: Optional[float] = None,
                seed: int = 0, rid0: int = 0) -> list[Request]:
    """``n`` requests all arriving at the same instant — the overload
    workload of the backpressure and deadline-shedding tests; the same
    seeded prompts as the reference's, greedy, so streams are
    bit-reproducible."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=rid0 + i,
            tokens=rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32),
            max_new_tokens=max_new_tokens,
            arrival=float(at),
            ttl=ttl,
        )
        for i in range(n)
    ]
