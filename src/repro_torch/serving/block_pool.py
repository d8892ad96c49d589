"""BlockPool — host-side allocator for the paged KV cache (own copy of the
JAX package's ``serving/block_pool.py``: the same decisions, op for op).

The contiguous engine gives every slot a private `max_len` cache row
(models/attention.py::init_kv_cache): a request can never outlive its row,
and a short request strands the rest of the row's HBM for its whole
lifetime.  The paged engine instead carves each layer's cache into
fixed-size KV BLOCKS (pages) of ``page_size`` positions and gives every
slot a BLOCK TABLE mapping logical page index -> physical page id
(vLLM-style).  This module is the allocator behind those tables:

  * one ``BlockPool`` per cache GROUP — layers sharing a cache geometry
    ('global' layers at size max_len, 'local' ring layers at size
    min(window, max_len)) share one id space, so a single table row
    addresses the same physical page slice in EVERY layer of the group;
  * a free list + per-page REFCOUNTS: pages referenced by several tables
    (shared prompt prefixes, serving/engine.py) are freed only when the
    last reference drops;
  * ``fork`` — the copy-on-write edge: a slot about to WRITE into a page
    it shares drops its shared reference and gets a fresh exclusive page
    (the device-side content copy is the caller's job — the pool only
    manages ids).  A fork never mutates the shared page: the other
    holders keep reading the original bits.

Everything here is plain numpy/python host state: allocation decisions
happen on the scheduler, on the host; decode and prefill only ever see the
resulting int32 tables (read on the device by the paged flash kernel,
gathered in the plain paths).  ``check`` is the invariant audit: the free
list and the live (refcount > 0) pages must exactly partition the pool,
and refcounts must match the references the caller declares.
"""
from __future__ import annotations

import numpy as np

__all__ = ["BlockPool"]


class BlockPool:
    """Fixed-capacity page allocator with refcounts and COW fork.

    n_blocks: physical pages in the pool (page ids are 0..n_blocks-1; the
    id ``n_blocks`` itself is the out-of-bounds SENTINEL unowned table
    entries carry — scatters to it drop, gathers clip into masked lanes).
    page_size: positions per page (bookkeeping only; the pool never
    touches tensor data).
    """

    def __init__(self, n_blocks: int, page_size: int):
        if n_blocks < 1:
            raise ValueError(f"BlockPool needs n_blocks >= 1 (got {n_blocks})")
        if page_size < 1:
            raise ValueError(f"BlockPool needs page_size >= 1 (got {page_size})")
        self.n_blocks = int(n_blocks)
        self.page_size = int(page_size)
        self.refcount = np.zeros(self.n_blocks, np.int32)
        # LIFO free list: most-recently-freed pages are re-issued first
        # (their content is hottest in HBM-adjacent caches; order is
        # otherwise irrelevant to correctness)
        self._free: list[int] = list(range(self.n_blocks - 1, -1, -1))
        self.n_forks = 0

    # -- queries -----------------------------------------------------------

    @property
    def sentinel(self) -> int:
        """Table-entry value for 'no page': one past the last valid id."""
        return self.n_blocks

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return int((self.refcount > 0).sum())

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # -- alloc / free / share ---------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """``n`` fresh exclusive pages (refcount 1 each).  Raises MemoryError
        when the pool cannot satisfy the request — callers gate admissions
        on ``can_alloc`` so this firing means a scheduler accounting bug."""
        if n > len(self._free):
            raise MemoryError(
                f"BlockPool: {n} pages requested, {len(self._free)} free "
                f"of {self.n_blocks}"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self.refcount[b] == 0
            self.refcount[b] = 1
        return out

    def incref(self, blocks) -> None:
        """Add one reference per listed page (prefix sharing: a new table
        row pointing at already-live pages).  Increffing a FREE page is a
        use-after-free — rejected loudly."""
        for b in blocks:
            b = int(b)
            if not (0 <= b < self.n_blocks) or self.refcount[b] == 0:
                raise ValueError(f"BlockPool.incref: page {b} is not live")
            self.refcount[b] += 1

    def free(self, blocks) -> None:
        """Drop one reference per listed page; pages reaching refcount 0
        return to the free list.  Freeing an already-free page (double
        free) is rejected loudly — the no-double-free invariant."""
        for b in blocks:
            b = int(b)
            if not (0 <= b < self.n_blocks) or self.refcount[b] == 0:
                raise ValueError(f"BlockPool.free: double free of page {b}")
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self._free.append(b)

    def fork(self, block: int) -> int:
        """Copy-on-write: trade one SHARED reference on ``block`` for a
        fresh exclusive page.  The shared page's other references — and its
        bits — are untouched; the caller copies the device content into the
        returned page before writing.  Forking an exclusively-held page is
        rejected (it would be a pointless copy — write in place instead)."""
        block = int(block)
        if not (0 <= block < self.n_blocks) or self.refcount[block] == 0:
            raise ValueError(f"BlockPool.fork: page {block} is not live")
        if self.refcount[block] < 2:
            raise ValueError(
                f"BlockPool.fork: page {block} is exclusively held "
                "(refcount 1) — write in place, don't fork"
            )
        new = self.alloc(1)[0]
        self.refcount[block] -= 1  # cannot hit 0: refcount was >= 2
        self.n_forks += 1
        return new

    # -- invariant audit ---------------------------------------------------

    def check(self, expected_refs=None) -> None:
        """Assert the pool invariants; raises AssertionError on violation.

        * free list and live (refcount > 0) pages PARTITION the pool:
          no page is both free and live, none is neither, no duplicates;
        * with ``expected_refs`` (iterable of page ids, one entry per
          outstanding reference the caller believes exists — table entries
          plus prefix-cache holds), refcounts must match it exactly.
        """
        free = list(self._free)
        assert len(set(free)) == len(free), "free list holds duplicates"
        for b in free:
            assert 0 <= b < self.n_blocks, f"free-list id {b} out of range"
            assert self.refcount[b] == 0, f"page {b} free but refcount > 0"
        live = np.nonzero(self.refcount > 0)[0]
        assert len(free) + len(live) == self.n_blocks, (
            f"free ({len(free)}) + live ({len(live)}) != {self.n_blocks}: "
            "pages leaked or double-tracked"
        )
        assert (self.refcount >= 0).all(), "negative refcount"
        if expected_refs is not None:
            want = np.zeros(self.n_blocks, np.int32)
            for b in expected_refs:
                want[int(b)] += 1
            if not (want == self.refcount).all():
                bad = np.nonzero(want != self.refcount)[0]
                raise AssertionError(
                    f"refcount mismatch on pages {bad.tolist()}: "
                    f"pool has {self.refcount[bad].tolist()}, caller "
                    f"references imply {want[bad].tolist()}"
                )
