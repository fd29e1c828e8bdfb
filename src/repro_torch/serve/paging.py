"""Paged KV cache bookkeeping (port of ``repro.serve.paging``).

Host-side state only.  Every attention layer's K/V (MLA: latents and
rope keys) lives in a shared
``(num_pages, page_size, ...)`` pool; one ``(batch, max_pages)`` int32
table maps slot ``b``'s row ``pos`` to ``(table[b, pos // page_size],
pos % page_size)``.  Page 0 is the reserved **trash page**: idle slots'
rows point at it, so their frozen decode writes land somewhere harmless.

Pages are refcounted so that requests sharing a page-aligned prompt
prefix map the same read-only pages (``PrefixCache``, the prefix index:
chunk keys chained by ``hash_chunks``, LRU leaf-first reclaim, an optional
cold tier).  ``HostPagePool`` is the host-memory tier that preemption
swap-out and prefix demotion share: refcounted ids whose payloads are
CPU tensors.

The classes are strict: double frees, foreign or reserved page ids,
out-of-range ids and cross-slot aliasing raise instead of silently
mapping one slot's KV rows into another's attention.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["PageAllocator", "PageTable", "PrefixCache", "HostPagePool",
           "pages_needed", "hash_chunks"]


def pages_needed(rows: int, page_size: int) -> int:
    """Pages required to hold ``rows`` cache rows."""
    if rows <= 0:
        return 0
    return -(-rows // page_size)


def hash_chunks(tokens, page_size: int) -> list[bytes]:
    """Hash-chain keys for every *full* page-aligned chunk of ``tokens``
    (the partial tail chunk is never indexed).  Chunk ``j``'s key
    digests chunk ``j-1``'s key plus chunk ``j``'s tokens, so one key
    commits to the entire prefix before it.  The digests (blake2b, 16
    bytes, over the int32 token bytes) are the reference's byte for byte:
    the keys name token content, not one engine's pool, so one chain can
    probe several replicas' indexes."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    keys, prev = [], b""
    for j in range(tokens.size // page_size):
        chunk = tokens[j * page_size:(j + 1) * page_size]
        prev = hashlib.blake2b(prev + chunk.tobytes(),
                               digest_size=16).digest()
        keys.append(prev)
    return keys


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


class HostPagePool:
    """Host-memory tier: refcounted page ids whose payloads (a page's
    KV rows as CPU tensors) live in host RAM.  Preemption swap-out parks
    an evicted slot's pages here, so resume is a page copy instead of a
    replay; the prefix index demotes reclaimed entries here.  Host ids
    are a namespace of their own (never in a page table, so no trash
    page: ``reserved=0``).  Refcounts are ``PageAllocator``'s; ``store``
    attaches a payload to a held page, ``load`` reads it back, and a
    payload dies with its page's last holder, so leaked host memory is
    exactly leaked pages."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self._alloc = PageAllocator(num_pages, reserved=0)
        self._data: dict[int, object] = {}

    @property
    def capacity(self) -> int:
        return self._alloc.capacity

    @property
    def available(self) -> int:
        return self._alloc.available

    @property
    def in_use(self) -> int:
        return self._alloc.in_use

    def refcount(self, page: int) -> int:
        return self._alloc.refcount(page)

    def can_alloc(self, n: int) -> bool:
        return self._alloc.can_alloc(n)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` host pages at refcount 1 each, or ``None`` (a full
        host tier falls back to replay-resume or plain reclaim)."""
        return self._alloc.alloc(n)

    def share(self, pages) -> None:
        self._alloc.share(pages)

    def free(self, pages) -> None:
        """Drop one reference per page; payloads die with their last
        holder."""
        pages = list(pages)
        self._alloc.free(pages)
        for p in pages:
            if self._alloc.refcount(p) == 0:
                self._data.pop(p, None)

    def store(self, page: int, payload) -> None:
        """Attach ``payload`` to a held page; raises on a page with no
        holder (storing into a recycled id would resurrect freed data)."""
        if self._alloc.refcount(page) < 1:
            raise ValueError(f"storing into host page {page} with no "
                             f"outstanding references")
        self._data[page] = payload

    def load(self, page: int):
        """Payload of a held page; raises if nothing was stored (a
        scheduler bug, not a cache miss)."""
        if page not in self._data:
            raise ValueError(f"host page {page} has no stored payload")
        return self._data[page]


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


class _PrefixEntry:
    __slots__ = ("page", "parent", "children", "last_used")

    def __init__(self, page: int, parent: bytes | None):
        self.page = page
        self.parent = parent
        self.children = 0
        self.last_used = 0


class PrefixCache:
    """Host-side prefix index: page-aligned prompt chunks → pool pages.

    A prompt's first ``len(prompt) // page_size`` full chunks are keyed
    by a running hash chain — chunk ``j``'s key digests chunk ``j-1``'s
    key plus chunk ``j``'s tokens, so one key commits to the *entire*
    prefix before it and two prompts share an entry only when every
    earlier token matches.  Each entry maps its key to the pool page
    holding that chunk's KV rows; the cache itself holds **one
    allocator reference per indexed page** (``insert`` shares, ``drop``
    / ``reclaim`` free), so a page survives the request that wrote it
    and later requests can map it read-only.

    Reclaim is LRU over *leaf* entries only (an interior chunk is never
    dropped before its descendants — a chain with a hole would be
    unreachable but still pinned), and only entries whose page has no
    holder besides the cache (refcount 1) are dropped: evicting a page
    another slot still maps would gain the pool nothing.

    **Cold tier.**  With :meth:`attach_cold_tier`, a reclaimed entry is
    *demoted* instead of forgotten: its page's rows are copied to a host
    page (the ``demote`` callback, backed by :class:`HostPagePool`) and
    the key survives in a cold index.  The device page is freed either
    way — reclaim's pool math is unchanged — but a later prompt whose
    hash chain reaches a cold run promotes those chunks back with an
    O(pages) host→device copy instead of recomputing their prefill.
    Demotion drops leaf-first, so the cold index holds contiguous chain
    *tails* whose hot prefix is still resident — exactly the shape
    :meth:`match_cold` extends a hot hit run with.  When the host pool
    is full the oldest cold entries die to make room; if it is still
    full the entry is simply dropped (the cold tier degrades to the old
    behaviour, never blocks reclaim).
    """

    def __init__(self, page_size: int, allocator: PageAllocator):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.allocator = allocator
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._clock = 0
        # cold tier: key -> host page id, in demotion order (oldest
        # first); installed by attach_cold_tier, absent by default
        self._cold: dict[bytes, int] = {}
        self._demote = None
        self._release = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> list[int]:
        """Pool pages currently pinned by the index."""
        return [e.page for e in self._entries.values()]

    def chunk_keys(self, tokens) -> list[bytes]:
        """Hash-chain keys for every *full* page-aligned chunk of
        ``tokens`` (the partial tail chunk is never indexed)."""
        return hash_chunks(tokens, self.page_size)

    def match(self, keys: list[bytes]) -> list[int]:
        """Pages of the longest cached *consecutive* chunk run from
        chunk 0.  Read-only: no references taken, no LRU bump — safe
        for admission-feasibility probes."""
        pages = []
        for key in keys:
            e = self._entries.get(key)
            if e is None:
                break
            pages.append(e.page)
        return pages

    def acquire(self, keys: list[bytes]) -> list[int]:
        """``match`` + take one reference per hit page for the caller
        (released through the allocator's normal ``free``) and bump the
        hit entries' LRU clocks."""
        pages = self.match(keys)
        self.allocator.share(pages)
        self._clock += 1
        for key in keys[:len(pages)]:
            self._entries[key].last_used = self._clock
        return pages

    def insert(self, keys: list[bytes], pages) -> int:
        """Index chunk ``j`` → ``pages[j]`` for every not-yet-cached
        chunk, taking the cache's own reference on each newly indexed
        page.  Returns the number of entries added.  ``pages`` must be
        live position-ordered pages of one slot's row (the caller just
        wrote — or mapped — those chunks' KV rows)."""
        pages = list(pages)
        if len(pages) < len(keys):
            raise ValueError(f"{len(keys)} chunk keys but only "
                             f"{len(pages)} pages")
        self._clock += 1
        added, prev = 0, None
        for key, page in zip(keys, pages):
            e = self._entries.get(key)
            if e is None:
                self.allocator.share([page])
                e = _PrefixEntry(page, prev)
                self._entries[key] = e
                if prev is not None:
                    self._entries[prev].children += 1
                added += 1
            e.last_used = self._clock
            prev = key
        return added

    def _droppable(self, keep=frozenset()):
        """Cold leaf entries whose page only the cache still holds."""
        return [(e.last_used, k) for k, e in self._entries.items()
                if e.children == 0 and e.page not in keep
                and self.allocator.refcount(e.page) == 1]

    def attach_cold_tier(self, demote, release) -> None:
        """Install host-tier callbacks: ``demote(page) -> host_id |
        None`` copies a device page's rows to a host page (None = host
        pool full), ``release(host_id)`` frees one.  The engine owns
        both — the index never touches cache tensors itself."""
        self._demote = demote
        self._release = release

    @property
    def cold_size(self) -> int:
        """Entries currently parked in the cold tier."""
        return len(self._cold)

    def match_cold(self, keys: list[bytes], skip: int) -> int:
        """Length of the consecutive cold-run extension of a hot hit
        run: how many of ``keys[skip:]`` sit in the cold index without a
        gap.  Read-only, like :meth:`match`."""
        n = 0
        for key in keys[skip:]:
            if key not in self._cold:
                break
            n += 1
        return n

    def pop_cold(self, keys: list[bytes]) -> list[int]:
        """Remove ``keys`` from the cold index and hand their host pages
        to the caller (promotion: the engine loads each payload into a
        fresh device page, then frees the host page).  Raises on a key
        that is not cold — promotion plans come from ``match_cold``."""
        missing = [k for k in keys if k not in self._cold]
        if missing:
            raise ValueError(f"{len(missing)} promotion key(s) not in the "
                             f"cold index")
        return [self._cold.pop(k) for k in keys]

    def _drop_entry(self, key: bytes) -> None:
        e = self._entries.pop(key)
        if e.parent is not None and e.parent in self._entries:
            self._entries[e.parent].children -= 1
        if self._demote is not None and key not in self._cold:
            hid = self._demote(e.page)
            while hid is None and self._cold:
                # cold tier full: the oldest demotions die to make room
                oldest = next(iter(self._cold))
                self._release(self._cold.pop(oldest))
                hid = self._demote(e.page)
            if hid is not None:
                self._cold[key] = hid
        self.allocator.free([e.page])

    def reclaim(self, n: int, keep=frozenset()) -> int:
        """Free up to ``n`` cold pages back to the pool, LRU leaf-first
        (dropping a leaf may expose its parent for the next round).
        ``keep`` protects pages an in-flight admission plan counts as
        hits.  Returns the number of pages actually freed."""
        keep = frozenset(keep)
        freed = 0
        while freed < n:
            cold = self._droppable(keep)
            if not cold:
                break
            cold.sort()
            for _, key in cold[:n - freed]:
                self._drop_entry(key)
                freed += 1
        return freed

    def reclaimable(self) -> int:
        """Pages ``reclaim`` could free right now (iterated to a fixed
        point on a shadow of the children counts — a cold chain frees
        its interior chunks once the leaves go)."""
        children = {k: e.children for k, e in self._entries.items()}
        dropped: set[bytes] = set()
        while True:
            cold = [k for k, e in self._entries.items()
                    if k not in dropped and children[k] == 0
                    and self.allocator.refcount(e.page) == 1]
            if not cold:
                return len(dropped)
            for k in cold:
                dropped.add(k)
                parent = self._entries[k].parent
                if parent in children:
                    children[parent] -= 1

    def drop(self) -> None:
        """Release every cache-held reference and clear the index (leak
        checks and engine teardown: after ``drop`` a drained engine's
        allocator must report ``in_use == 0``)."""
        for e in self._entries.values():
            self.allocator.free([e.page])
        self._entries.clear()
        if self._release is not None:
            for hid in self._cold.values():
                self._release(hid)
        self._cold.clear()
