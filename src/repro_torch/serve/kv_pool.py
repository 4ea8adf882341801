"""Paged KV block allocator: a fixed pool of ``num_pages`` pages of
``page_size`` token rows each, shared by every batch slot.

A copy of ``repro/serve/kv_pool.py`` (plain numpy): the port keeps its own
copy so that it never imports the JAX package.

ExpoCloud's core economy is releasing resources the moment they stop
earning their keep; the dense per-slot KV stripe violates that at the
memory layer (every slot owns ``max_seq`` rows even for a 5-token
request).  The pool decouples resident memory from ``slots × max_seq``:

  * each slot holds a *page table* — logical page ``j`` of the slot maps
    to physical page ``table[slot, j]`` in the pool,
  * pages are allocated lazily as a slot's KV length crosses page
    boundaries, and freed O(1) when the request retires or is preempted
    (the free list is a plain LIFO stack),
  * the allocator is pure host-side bookkeeping — device scatter/gather
    through the (traced) page tables lives in the model layer.

Accounting is first-class: ``used_pages``, ``high_water``, per-slot
``footprint``, and alloc/free counters, so admission control and the
serve bench can reason about memory instead of worst-case provisioning.
"""
from __future__ import annotations

import numpy as np


class PoolExhausted(Exception):
    """Raised by ``alloc`` when the free list cannot cover a request."""


class KVPool:
    """Host-side page allocator for a paged KV cache.

    Parameters
    ----------
    num_pages : total physical pages in the pool.
    page_size : token rows per page.
    slots     : number of batch slots (page-table rows).
    max_seq   : engine sequence bound; fixes the page-table width at
                ``ceil(max_seq / page_size)``.
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_seq: int):
        assert num_pages >= 1 and page_size >= 1, (num_pages, page_size)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.width = -(-int(max_seq) // self.page_size)  # ceil
        # LIFO free list: O(1) alloc/free, no fragmentation (unit pages).
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        # table[s, j] = physical page backing the slot's logical page j.
        # Unmapped entries hold the sentinel ``num_pages``: readers mask
        # by kv_len (stale entries are never attended; gathers clamp),
        # and a write scattered through a sentinel computes an
        # out-of-range flat row and is dropped — defence in depth on top
        # of allocation preceding every write.
        self.table = np.full((self.slots, self.width), self.num_pages,
                             np.int32)
        self._owned: list[list[int]] = [[] for _ in range(self.slots)]
        self.high_water = 0
        self.total_allocs = 0
        self.total_frees = 0

    # -- accounting ----------------------------------------------------
    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def footprint(self, slot: int) -> int:
        """Pages currently owned by ``slot``."""
        return len(self._owned[slot])

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to back token rows ``0 .. n_tokens-1``."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "high_water": self.high_water,
            "total_allocs": self.total_allocs,
            "total_frees": self.total_frees,
        }

    # -- allocation ----------------------------------------------------
    def needed(self, slot: int, upto_pos: int) -> int:
        """Extra pages ``slot`` needs so row ``upto_pos`` is backed."""
        want = self.pages_for(int(upto_pos) + 1)
        return max(0, want - len(self._owned[slot]))

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    def alloc(self, slot: int, upto_pos: int) -> list[int]:
        """Grow ``slot`` so token row ``upto_pos`` is backed.

        Returns the newly allocated physical page ids (possibly empty).
        Raises :class:`PoolExhausted` — allocating nothing — if the free
        list is short; callers preempt or defer and retry."""
        need = self.needed(slot, upto_pos)
        if need > len(self._free):
            raise PoolExhausted(
                f"slot {slot} needs {need} pages, {len(self._free)} free")
        owned = self._owned[slot]
        fresh = [self._free.pop() for _ in range(need)]
        for page in fresh:
            self.table[slot, len(owned)] = page
            owned.append(page)
        self.total_allocs += need
        self.high_water = max(self.high_water, self.used_pages)
        return fresh

    def free_slot(self, slot: int) -> int:
        """Release every page owned by ``slot``; O(pages owned)."""
        owned = self._owned[slot]
        n = len(owned)
        self._free.extend(owned)
        self.total_frees += n
        self._owned[slot] = []
        self.table[slot, :] = self.num_pages
        return n
