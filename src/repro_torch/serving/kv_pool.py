"""Paged ragged KV pool: the serving engine's page-granular KV allocator.

The port's copy of ``repro/serving/kv_pool.py`` (pure Python and numpy, so
the same bookkeeping runs beside either package).

The contiguous per-slot KV batch (`zero_state(cfg, num_slots, cache_len)`)
ties a request's KV residency to a *batch row* for its whole lifetime: a
finished row's cache idles until the group drains, and admission is gated on
batch geometry. The pool replaces that with vLLM-style paging: the donated KV
planes are carved into fixed-size pages (`transformer.paged_zero_state` — one
shared [num_pages + 1, page_size, Hkv, dh] plane per layer per k/v), and each live
request owns an ordered *page table* mapping its logical cache slots
`0..cap-1` to physical pages. Rows join and leave a live decode window
between launches; a finishing request's pages return to the free list
immediately and the next queued request prefills into them.

This class is the HOST-side bookkeeping only. Device addressing happens in
`attention_decode(page_table=...)`: on the card K2's paged entry reads each
row's pages through the table itself; the plain CPU path gathers the row's
logical view, bitwise equal to the contiguous layout.

Physical page 0 is the reserved scratch page: it is never handed out, pad
rows of a bucketed window carry all-zero page tables (their writes land in
scratch and their telemetry is masked with ``accepted=0``), and unallocated
page-table tail entries point at it. Stale contents of freed/unallocated
pages never need zeroing: every cache position beyond a row's true length is
masked to exact-zero attention probability, and only finite values are ever
written, so garbage contributes ±0.0 to the context sum — bit-identical to a
freshly zeroed cache.

Admission discipline (deadlock freedom): `reserve()` claims the WORST-CASE
page count for a request (prompt + full declared output budget, clamped to
the per-row capacity) before it is admitted; physical pages are then drawn
lazily by `ensure()` as the sequence grows, which therefore can never fail
mid-flight — no request ever stalls inside a window waiting for memory. The
continuous-batching win comes from early finishes (EOS / deadline): pages a
reservation never used return at `release()` and admit the next request
mid-stream rather than at a group boundary.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class PagePoolError(RuntimeError):
    """An allocation invariant was violated (ensure past reservation/pool)."""


class KVPagePool:
    def __init__(self, num_pages: int, page_size: int, row_pages: int,
                 tracer=None):
        assert num_pages >= row_pages >= 1 and page_size >= 1
        # optional repro_torch.obs.Tracer: reserve/ensure/release emit page-id
        # events the contract auditor replays for use-after-release checks
        self.tracer = tracer
        self.num_pages = num_pages          # allocatable pages (ids 1..num_pages)
        self.page_size = page_size
        self.row_pages = row_pages          # pages a full row spans (cap/page_size)
        self.row_capacity = row_pages * page_size
        # LIFO free list: freshly released pages are reused first, so stale
        # contents are recycled as aggressively as possible (the exactness
        # tests lean on this to exercise the garbage-is-masked contract)
        self._free: List[int] = list(range(num_pages, 0, -1))
        self._tables: Dict[int, List[int]] = {}      # uid -> ordered pages
        self._reserved: Dict[int, int] = {}          # uid -> reserved page count

    # -- accounting --------------------------------------------------------
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return sum(len(t) for t in self._tables.values())

    @property
    def pages_reservable(self) -> int:
        """Free pages not yet spoken for by an admitted request's unallocated
        reservation remainder — what admission may promise to a NEW request."""
        backlog = sum(
            r - len(self._tables.get(uid, []))
            for uid, r in self._reserved.items()
        )
        return len(self._free) - backlog

    def pages_for(self, tokens: int) -> int:
        """Pages a sequence of ``tokens`` cache positions occupies (clamped to
        the per-row capacity — ring semantics wrap longer sequences)."""
        tokens = min(max(int(tokens), 0), self.row_capacity)
        return -(-tokens // self.page_size)

    # -- lifecycle ---------------------------------------------------------
    def reserve(self, uid: int, pages: int) -> bool:
        """Claim ``pages`` worst-case pages for ``uid`` (admission gate).
        Returns False — without admitting — when the unreserved remainder of
        the free list cannot cover it."""
        assert uid not in self._reserved, f"uid {uid} already reserved"
        if pages > self.pages_reservable:
            return False
        self._reserved[uid] = pages
        if self.tracer is not None:
            self.tracer.instant("kv_reserve", "kv_pool",
                                args={"uid": uid, "pages": pages})
        return True

    def ensure(self, uid: int, tokens: int) -> int:
        """Grow ``uid``'s page table to cover ``tokens`` cache positions;
        returns the number of pages newly allocated. Draws only from the
        request's reservation when one exists — admission sized it worst-case,
        so a reserved request can never fail here."""
        tbl = self._tables.setdefault(uid, [])
        target = self.pages_for(tokens)
        reserved = self._reserved.get(uid)
        if reserved is not None and target > reserved:
            raise PagePoolError(
                f"uid {uid} needs {target} pages but reserved only {reserved}"
            )
        grew = 0
        while len(tbl) < target:
            if not self._free:
                raise PagePoolError(f"page pool exhausted growing uid {uid}")
            tbl.append(self._free.pop())
            grew += 1
        if grew and self.tracer is not None:
            self.tracer.instant("kv_ensure", "kv_pool",
                                args={"uid": uid, "pages": tbl[-grew:]})
        return grew

    def release(self, uid: int) -> int:
        """Return ``uid``'s pages (and any unused reservation) to the pool;
        returns the number of pages freed. Freed pages are NOT zeroed — stale
        contents are masked exactly (module docstring)."""
        freed = self._tables.pop(uid, [])
        self._reserved.pop(uid, None)
        self._free.extend(reversed(freed))     # LIFO: newest-freed reused first
        if freed and self.tracer is not None:
            self.tracer.instant("kv_release", "kv_pool",
                                args={"uid": uid, "pages": list(freed)})
        return len(freed)

    # -- device view -------------------------------------------------------
    def table(self, uid: int) -> List[int]:
        return list(self._tables.get(uid, []))

    def table_array(self, uid: int) -> np.ndarray:
        """Fixed-shape [row_pages] int32 page table for one batch row;
        unallocated tail entries point at the scratch page 0."""
        out = np.zeros((self.row_pages,), np.int32)
        tbl = self._tables.get(uid, [])
        out[: len(tbl)] = tbl
        return out

    # -- invariants (property tests) ---------------------------------------
    def check(self) -> None:
        allocated = [p for t in self._tables.values() for p in t]
        assert len(allocated) == len(set(allocated)), "page double-allocated"
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicate"
        assert not (free & set(allocated)), "page both free and allocated"
        assert 0 not in free and 0 not in allocated, "scratch page leaked out"
        assert len(allocated) + len(self._free) == self.num_pages, "page leaked"
        for uid, r in self._reserved.items():
            assert len(self._tables.get(uid, [])) <= r, f"uid {uid} overdrew"
        assert self.pages_reservable >= 0, "reservations overcommit the pool"
