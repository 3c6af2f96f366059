"""Host-side free-list allocator for the shared KV page pool (a copy of
``repro.serve.paging``).

Pure python bookkeeping — the device arena (``models.layers.
PagedKVCache``) never moves; this module only decides which physical
page ids a request's block table points at.  Ownership is tracked per
page so double-frees and foreign-page releases fail loudly instead of
silently corrupting another request's KV state.

Kept deliberately standalone (no torch imports) so the allocator
invariants — conservation, no double allocation, exact-coverage block
tables — are property-testable without touching a device.
"""

from __future__ import annotations


class PagePool:
    """Fixed arena of ``n_pages`` pages of ``page_size`` token slots.

    ``alloc``/``release`` move page ids between the free list and the
    per-request ownership map; lowest-numbered free pages are handed out
    first (keeps smoke-test tables deterministic and dense)."""

    __slots__ = ("n_pages", "page_size", "_free", "_owner")

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free = list(range(self.n_pages - 1, -1, -1))  # pop() -> lowest
        self._owner: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` token slots (at least one —
        every admitted request owns a page for its first decode write)."""
        return max(1, -(-int(tokens) // self.page_size))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, rid: int) -> list[int]:
        """Take ``n`` pages for request ``rid``; raises ``MemoryError``
        when the pool can't satisfy it (callers preempt or stall)."""
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, free {len(self._free)}"
                f"/{self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = rid
        return pages

    def release(self, pages, rid: int) -> None:
        """Return ``pages`` (owned by ``rid``) to the free list.
        Ownership is validated for the whole batch *before* any page is
        freed, so a rejected release leaves the pool untouched."""
        for p in pages:
            owner = self._owner.get(p)
            if owner != rid:
                raise ValueError(
                    f"release of page {p} by rid {rid}: owned by {owner}")
        for p in pages:
            del self._owner[p]
            self._free.append(p)

    def owner(self, page: int):
        return self._owner.get(page)
