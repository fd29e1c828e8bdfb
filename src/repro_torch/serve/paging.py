"""Paged KV cache bookkeeping (port of ``repro.serve.paging``:
``pages_needed``, ``PageAllocator``, ``PageTable``; the host pool and the
prefix cache wait for their slices).

Host-side state only.  Every attention layer's K/V lives in a shared
``(num_pages, page_size, ...)`` pool; one ``(batch, max_pages)`` int32
table maps slot ``b``'s row ``pos`` to ``(table[b, pos // page_size],
pos % page_size)``.  Page 0 is the reserved **trash page**: idle slots'
rows point at it, so their frozen decode writes land somewhere harmless.

Both classes are strict: double frees, foreign or reserved page ids,
out-of-range ids and cross-slot aliasing raise instead of silently
mapping one slot's KV rows into another's attention.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PageAllocator", "PageTable", "pages_needed"]


def pages_needed(rows: int, page_size: int) -> int:
    """Pages required to hold ``rows`` cache rows."""
    if rows <= 0:
        return 0
    return -(-rows // page_size)


class PageAllocator:
    """Refcounted LIFO free-list over ``num_pages`` pages; the first
    ``reserved`` ids are never handed out.  ``alloc`` is all-or-nothing
    and returns ``None`` when the pool cannot satisfy it (backpressure);
    ``share`` adds a holder; ``free`` drops one and recycles a page when
    its count reaches zero."""

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(f"num_pages {num_pages} must exceed the "
                             f"{reserved} reserved page(s)")
        self.num_pages = num_pages
        self.reserved = reserved
        # LIFO: freshly freed pages are reused first
        self._free: list[int] = list(range(num_pages - 1, reserved - 1, -1))
        self._refs: dict[int, int] = {}

    @property
    def capacity(self) -> int:
        """Allocatable pages (pool minus reserved)."""
        return self.num_pages - self.reserved

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages with at least one holder."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages at refcount 1, or ``None`` if unavailable."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages) -> None:
        """One extra holder per page; only live pages can be shared."""
        pages = list(pages)
        bad = [p for p in pages if p not in self._refs]
        if bad:
            raise ValueError(f"sharing pages not currently allocated: {bad}")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; raises on a page with none."""
        pages = list(pages)
        bad = [p for p in pages if p not in self._refs]
        if bad:
            raise ValueError(f"freeing pages not currently allocated: {bad}")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


class PageTable:
    """Mutable host mirror of the ``(batch, max_pages)`` device table.
    Entries default to ``trash_page``; ``assign`` fills a slot's row
    prefix, ``extend`` appends to it, ``truncate`` shrinks it.  Page ids
    are validated on every mutation (pool bounds, reserved range,
    duplicates within a row, aliasing with another slot's live prefix
    unless declared ``shared``)."""

    def __init__(self, batch: int, max_pages: int, trash_page: int = 0,
                 num_pages: int | None = None, reserved: int = 1):
        self.batch = batch
        self.max_pages = max_pages
        self.trash_page = trash_page
        self.num_pages = num_pages
        self.reserved = reserved
        self.table = np.full((batch, max_pages), trash_page, np.int32)
        self._live_len = np.zeros((batch,), np.int64)

    def _validate(self, slot: int, pages: np.ndarray,
                  shared=frozenset()) -> None:
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} out of range [0, {self.batch})")
        if pages.ndim != 1:
            raise ValueError(f"pages must be a flat id list, got shape "
                             f"{pages.shape}")
        if self.num_pages is not None:
            oob = pages[(pages < 0) | (pages >= self.num_pages)]
            if oob.size:
                raise ValueError(f"page ids {sorted(set(oob.tolist()))} out "
                                 f"of pool range [0, {self.num_pages})")
        rsv = pages[pages < self.reserved]
        if rsv.size:
            raise ValueError(f"page ids {sorted(set(rsv.tolist()))} are in "
                             f"the reserved range [0, {self.reserved}) "
                             f"(trash page {self.trash_page} cannot carry "
                             f"live rows)")
        if np.unique(pages).size != pages.size:
            dup = sorted({int(p) for p in pages if (pages == p).sum() > 1})
            raise ValueError(f"duplicate page ids within one row: {dup}")
        for other in range(self.batch):
            if other == slot:
                continue
            live = self.table[other, :self._live_len[other]]
            alias = np.intersect1d(pages, live)
            alias = alias[~np.isin(alias, list(shared))] if shared else alias
            if alias.size:
                raise ValueError(f"page ids {alias.tolist()} are already "
                                 f"live in slot {other}")

    def assign(self, slot: int, pages, shared=frozenset()) -> None:
        """Point slot ``slot``'s row prefix at ``pages`` (rest trash)."""
        pages = np.asarray(pages, np.int32).reshape(-1)
        if pages.size > self.max_pages:
            raise ValueError(f"{pages.size} pages exceed the per-slot "
                             f"maximum of {self.max_pages}")
        self._validate(slot, pages, frozenset(shared))
        self.table[slot] = self.trash_page
        self.table[slot, :pages.size] = pages
        self._live_len[slot] = pages.size

    def extend(self, slot: int, pages) -> None:
        """Append ``pages`` to slot ``slot``'s live prefix."""
        pages = np.asarray(pages, np.int32).reshape(-1)
        self._validate(slot, pages)
        n = int(self._live_len[slot])
        if n + pages.size > self.max_pages:
            raise ValueError(f"extending slot {slot} to {n + pages.size} "
                             f"pages exceeds the per-slot maximum of "
                             f"{self.max_pages}")
        dup = np.intersect1d(pages, self.table[slot, :n])
        if dup.size:
            raise ValueError(f"page ids {dup.tolist()} are already live in "
                             f"slot {slot}")
        self.table[slot, n:n + pages.size] = pages
        self._live_len[slot] = n + pages.size

    def truncate(self, slot: int, n_pages: int) -> list[int]:
        """Shrink the live prefix to ``n_pages``, re-pointing the removed
        tail at the trash page; returns the removed ids in order."""
        if n_pages < 0:
            raise ValueError(f"cannot truncate slot {slot} to {n_pages} "
                             f"pages")
        n = int(self._live_len[slot])
        if n_pages >= n:
            return []
        removed = self.table[slot, n_pages:n].tolist()
        self.table[slot, n_pages:n] = self.trash_page
        self._live_len[slot] = n_pages
        return removed

    def live_len(self, slot: int) -> int:
        return int(self._live_len[slot])

    def clear(self, slot: int) -> None:
        self.table[slot] = self.trash_page
        self._live_len[slot] = 0

    def row(self, slot: int) -> np.ndarray:
        return self.table[slot].copy()

    def asarray(self) -> np.ndarray:
        return self.table
