"""Host-side free-list allocator for the paged KV pool, the counterpart
of ``idc_models_tpu/serve/pages.py``.

The device holds one fixed page pool per block -- [n_pages, page_size,
H, D] K and V tensors -- and an [S, t_max/page_size] int32 page table
mapping each slot's logical pages to physical ones (``serve/engine.py``,
paged mode). This class owns the physical pages: admission asks it for
pages covering the prompt plus the decode reservation, slot release
returns them, and the radix prefix cache (``serve/prefix_cache.py``)
retains extra references so a snapshot's pages outlive the slot that
wrote them.

Pages are reference counted, not exclusively owned: a chunk-boundary
snapshot shares the very pages the prefilling slot wrote (page-aligned
and never written again), so a prefix-cache hit costs no copy and a
shared page is freed only when its last holder (slot or snapshot)
releases it.

Allocation is deterministic (lowest free id first, through a heap): the
same sequence of calls grants the same page ids as the JAX allocator's.
"""

from __future__ import annotations

import heapq

import numpy as np


class PageExhausted(RuntimeError):
    """Raised when a grant cannot be satisfied. The scheduler's
    admission gate (`SlotEngine.can_admit_pages`) makes this unreachable
    on the admission path; mid-decode growth surfaces it as a
    per-request quarantine instead."""


class PageAllocator:
    """Free list + refcounts over `n_pages` fixed-size KV pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"need n_pages >= 1, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"need page_size >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free = list(range(self.n_pages))
        heapq.heapify(self._free)
        self._refs = np.zeros(self.n_pages, np.int64)

    # -- grants -----------------------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """Grant `n` fresh pages (refcount 1 each), lowest ids first;
        None -- and no partial grant -- when fewer than `n` are free."""
        if n < 0:
            raise ValueError(f"need n >= 0, got {n}")
        if n > len(self._free):
            return None
        out = [heapq.heappop(self._free) for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def retain(self, pages) -> None:
        """Add one reference to each page (a prefix-cache snapshot, or a
        hit handing shared prefix pages to a new slot)."""
        for p in pages:
            if self._refs[p] < 1:
                raise ValueError(f"retain of free page {p}")
            self._refs[p] += 1

    def release(self, pages) -> int:
        """Drop one reference per page; pages reaching zero return to
        the free list. Returns how many were freed."""
        freed = 0
        for p in pages:
            if self._refs[p] < 1:
                raise ValueError(f"release of free page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                heapq.heappush(self._free, int(p))
                freed += 1
        return freed

    # -- accounting -------------------------------------------------------

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])
