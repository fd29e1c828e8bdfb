"""Slot-based continuous-batching serve engine (port of
``repro.serve.engine``).

Each batch slot is an independent sequence sharing one model:

* **Prefill into a free slot.**  A new request is prefilled alone (batch
  1), its prompt zero-padded to the slot budget ``prefill_len``, and its
  caches are copied into the slot's row of the dense slab or, paged, into
  the pool pages its table row maps.  Pad-token rows are harmless: decode
  overwrites row ``p`` before any query attends to it.
* **Decode chunks.**  ``decode_chunk`` greedy steps run back to back on
  the device at per-slot positions.  Slots that are idle or finished keep
  running *frozen* on their last token and position (their rewrites land
  on already-written rows, or paged, on the trash page) - the batch
  composition stays what the reference engine runs, which matters
  because the w8a8 activation scale is taken over the whole batch.
* **Paged KV cache.**  ``alloc_mode="reserve"`` books a request's
  worst-case pages at admission and defers (backpressure) when the pool
  cannot cover them; ``alloc_mode="incremental"`` books the prompt pages
  plus the first decode page and tops a slot up before any chunk whose
  writes would cross its last page, so ``num_pages`` may sit below the
  sum of worst cases (overcommit).
* **Preemption.**  When a top-up finds the pool dry, or a strictly
  stronger arrival (aging-adjusted priority) finds no slot or no pages,
  the weakest runner is evicted: its pages go back to the pool, its table
  row to the trash page, and the request re-enters the queue carrying its
  tokens.  On re-admission the prompt is prefilled again and the stored
  tokens are teacher-forced back through the decode chunk, so a greedy
  stream resumes exactly as an uninterrupted one wherever rows do not
  depend on each other (``quant_mode="dense"``).
* **Host swap** (``swap_mode="host"``).  Eviction copies the victim's
  live pages to a ``HostPagePool`` (CPU tensors), and re-admission copies
  them back into fresh pages: a page copy instead of a re-prefill and a
  replay (a bit copy, so the stream resumes exactly).  A full host pool
  falls back to replay.
* **Prefix cache** (``prefix_cache=True``).  Page-aligned prompt chunks
  are indexed by hash chain (``PrefixCache``); an admission maps the
  cached pages read-only and prefills only the suffix against them
  (context prefill, one stage signature for miss, hit and copy-on-write).
  A fully covered prompt copies its shared tail page into a private one
  before writing its last row (COW).  Unpinned entries are reclaimed LRU
  leaf-first under pool pressure or above ``prefix_cache_pages``; with
  the host swap they are demoted to host pages and promoted back on a
  later hit.
* **Priority queue** with optional aging, as in the reference.

Not ported yet (the knobs raise ``NotImplementedError``): sampling with
``temperature > 0`` (the reference draws from threefry keys that no other
framework reproduces), speculative decoding, chunked / grouped prefill
and tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (
    copy_paged_cache_page,
    decode_step,
    extract_cache_pages,
    init_caches,
    insert_cache_pages,
    merge_slot_caches,
    merge_slot_paged_caches,
    prefill,
    scatter_prefill_paged_caches,
)
from repro_torch.serve.paging import (
    HostPagePool,
    PageAllocator,
    PageTable,
    PrefixCache,
    pages_needed,
)

__all__ = ["ServeConfig", "Request", "Engine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int                        # concurrent decode slots
    max_len: int                      # per-slot cache budget (tokens)
    temperature: float = 0.0          # 0 = greedy (the only ported mode)
    eos_id: int = -1                  # -1 = length-only stopping
    prefill_len: int = 0              # slot prompt budget (prompts are
    #   zero-padded to it); 0 = prefill at exact prompt length
    decode_chunk: int = 8             # greedy steps per decode chunk
    priority_aging_s: float = 0.0     # seconds per +1 effective priority
    #   (queued and running requests alike: it also gates preemption)
    alloc_mode: str = "reserve"       # paged page accounting: "reserve"
    #   (worst case at admission) or "incremental" (live pages, top-up
    #   per chunk, evict-and-resume when the pool runs dry)
    # serving-time overrides of the model config; None keeps its value
    quant_mode: str | None = None
    quant_backend: str | None = None
    cache_mode: str | None = None
    page_size: int | None = None
    num_pages: int | None = None
    prefix_cache: bool = False        # paged only: share read-only prompt
    #   prefix pages across requests (hash-indexed page-aligned chunks,
    #   refcounted pages, COW on a fully covered prompt's tail page); an
    #   admission prefills only the uncached suffix
    prefix_cache_pages: int = 0       # cap on pages the prefix index pins
    #   (LRU reclaim after each insert, best effort); 0 = uncapped
    swap_mode: str = "off"            # "host": evicted slots' pages go to
    #   a host pool and come back by copy on resume (and the prefix cache
    #   gets a cold tier); "off" = replay-only resume.  Paged only
    host_pages: int = 0               # host pool pages; 0 = twice the
    #   device pool's allocatable pages
    # reference knobs outside this slice: non-default values raise
    spec_decode: bool = False
    prefill_chunk: int = 0
    admit_group: int = 1
    tp: int = 1
    mesh_shape: tuple | None = None


_UNPORTED = (("temperature", 0.0), ("spec_decode", False),
             ("prefill_chunk", 0), ("admit_group", 1), ("tp", 1),
             ("mesh_shape", None))


def _apply_overrides(cfg: ModelConfig, scfg: ServeConfig) -> ModelConfig:
    updates = {f: getattr(scfg, f) for f in ("quant_mode", "quant_backend",
                                             "cache_mode", "page_size",
                                             "num_pages")
               if getattr(scfg, f) is not None}
    return cfg.replace(**updates) if updates else cfg


@dataclasses.dataclass
class Request:
    """One generation request (host-side bookkeeping)."""
    id: int
    prompt: np.ndarray                # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0              # seconds after Engine.run() starts
    priority: int = 0                 # higher = served first
    tokens: list = dataclasses.field(default_factory=list)
    t_first: float = -1.0             # time to first token (from run t0)
    t_done: float = -1.0
    t_tokens: list = dataclasses.field(default_factory=list)  # emission
    #   times; replayed tokens keep their original stamps
    cache_rows: int = 0               # peak cache rows held for the request
    truncated: bool = False           # max_new_tokens cut to fit max_len
    preemptions: int = 0              # times evicted mid-stream and resumed
    chunk_keys: list | None = None    # memoized hash chain of the prompt's
    #   page-aligned chunks (prefix cache)
    swap_pages: list | None = None    # host pages holding the swapped-out
    #   rows while the request waits; None = resume replays
    swap_rows: int = 0                # rows captured at swap-out (the
    #   slot's decode position); later tokens re-enter the forcing lane


class _PriorityQueue:
    """Arrival-gated max-priority queue with lazy aging, keyed
    ``(-priority, arrival, seq)`` (the reference's ordering)."""

    def __init__(self, aging_s: float = 0.0):
        self.aging_s = aging_s
        self._heap: list[tuple] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (-req.priority, req.arrival, self._seq,
                                    req))
        self._seq += 1

    def effective(self, req: Request, now: float) -> int:
        """Aging-adjusted priority (the same measure ranks runners for
        eviction, so equal-priority requests never evict each other)."""
        if self.aging_s <= 0:
            return req.priority
        return req.priority + int(max(0.0, now - req.arrival)
                                  / self.aging_s)

    def next_arrival(self) -> float | None:
        return min((e[1] for e in self._heap), default=None)

    def _best_index(self, now: float) -> int | None:
        if not self._heap:
            return None
        if self.aging_s <= 0 and self._heap[0][1] <= now:
            return 0
        best_i, best_key = None, None
        for i, (_, arr, seq, req) in enumerate(self._heap):
            if arr > now:
                continue
            key = (-self.effective(req, now), arr, seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i

    def peek(self, now: float) -> Request | None:
        i = self._best_index(now)
        return None if i is None else self._heap[i][3]

    def pop(self, now: float, admit: Callable[[Request], bool] = None):
        """Remove and return the best arrived request, or ``None``;
        ``admit`` vetoes the winner without removing it."""
        best_i = self._best_index(now)
        if best_i is None:
            return None
        req = self._heap[best_i][3]
        if admit is not None and not admit(req):
            return None
        self._heap[best_i] = self._heap[-1]
        self._heap.pop()
        heapq.heapify(self._heap)
        return req


class _StageCounter:
    """Distinct call signatures of one engine stage: the shape and dtype
    of each tensor argument, the type name of any other.  Stands in for
    the reference's ``_CountingJit``.  PyTorch compiles nothing here, but a
    stage that keeps one signature is one a CUDA graph captured once can
    replay, so the count pins the same contract: a warm engine reads
    ``{"prefill": 1, "decode_chunk": 1}`` across request mixes, page
    recyclings and preemptions (given a fixed ``prefill_len``)."""

    def __init__(self):
        self._keys: set = set()

    def record(self, *args) -> None:
        self._keys.add(tuple(
            (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
            else (type(a).__name__,) for a in args))

    @property
    def count(self) -> int:
        return len(self._keys)


class Engine:
    """Continuous-batching greedy engine over a dense or paged KV cache,
    with incremental page allocation, evict-and-resume preemption, the
    prefix cache and the host swap tier.
    ``params`` come from ``model_init`` or ``load_jax_params`` on the
    same device; ``device`` defaults to CUDA and raises without a card."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 device="cuda"):
        self.device = resolve_device(device)
        for field, default in _UNPORTED:
            if getattr(scfg, field) != default:
                raise NotImplementedError(
                    f"ServeConfig.{field}={getattr(scfg, field)!r} is not "
                    f"ported yet (ROADMAP queue 1)")
        if scfg.alloc_mode not in ("reserve", "incremental"):
            raise ValueError(f"alloc_mode must be 'reserve' or "
                             f"'incremental', got {scfg.alloc_mode!r}")
        if scfg.prefill_len > scfg.max_len:
            raise ValueError(f"prefill_len {scfg.prefill_len} exceeds "
                             f"max_len {scfg.max_len}")
        if scfg.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{scfg.decode_chunk}")
        self.cfg = _apply_overrides(cfg, scfg)
        self.params, self.scfg = params, scfg
        self._paged = self.cfg.cache_mode == "paged"
        self._incremental = scfg.alloc_mode == "incremental"
        if self._incremental and not self._paged:
            raise ValueError("alloc_mode='incremental' requires "
                             "cache_mode='paged' (the dense slab has no "
                             "pages to grow)")
        if self._paged:
            ps = self.cfg.page_size
            if ps < 1:
                raise ValueError(f"page_size must be >= 1, got {ps}")
            if scfg.max_len % ps:
                raise ValueError(f"max_len {scfg.max_len} must be a "
                                 f"multiple of page_size {ps}")
            self._page_size = ps
            self._max_pages = scfg.max_len // ps
            self._num_pages = (self.cfg.num_pages
                               or scfg.batch * self._max_pages + 1)
            self.cfg = self.cfg.replace(num_pages=self._num_pages)
        elif self.cfg.cache_mode != "dense":
            raise ValueError(f"cache_mode must be 'dense' or 'paged', got "
                             f"{self.cfg.cache_mode!r}")
        self._swap = scfg.swap_mode == "host"
        self._validate_tiers()
        self._caches = init_caches(self.cfg, scfg.batch, scfg.max_len,
                                   device=self.device)
        self._stages = {"prefill": _StageCounter(),
                        "decode_chunk": _StageCounter()}
        self._next_id = 0
        self.reset()

    def _validate_tiers(self) -> None:
        """The prefix cache's and the host swap's config rules (the
        reference's checks and messages)."""
        scfg = self.scfg
        has_mamba = any(s.mixer == "mamba" for s in self.cfg.layer_specs)
        if scfg.swap_mode not in ("off", "host"):
            raise ValueError(f"swap_mode must be 'off' or 'host', got "
                             f"{scfg.swap_mode!r}")
        if scfg.host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got "
                             f"{scfg.host_pages}")
        if scfg.prefix_cache_pages < 0:
            raise ValueError(f"prefix_cache_pages must be >= 0, got "
                             f"{scfg.prefix_cache_pages}")
        if scfg.prefix_cache:
            if not self._paged:
                raise ValueError("prefix_cache=True requires "
                                 "cache_mode='paged' (the dense slab has "
                                 "no pages to share)")
            if has_mamba:
                raise ValueError("prefix_cache=True is incompatible with "
                                 "mamba-mixer models: SSM state is "
                                 "sequential and cannot be composed from "
                                 "a cached prefix")
            if self.cfg.kv_cache_dtype == "int8":
                raise ValueError("prefix_cache=True is incompatible with "
                                 "kv_cache_dtype='int8': cached rows are "
                                 "attended dequantized while a solo "
                                 "prefill attends full precision")
        if self._swap:
            if not self._paged:
                raise ValueError("swap_mode='host' requires "
                                 "cache_mode='paged': the dense slab has "
                                 "no pages to swap")
            if has_mamba:
                raise ValueError("swap_mode='host' is incompatible with "
                                 "mamba-mixer models: recurrent state is "
                                 "per-slot, not paged")

    # ------------------------------------------------------------------
    # host-side state
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Clear queue, slots and counters (cache buffers and stage
        counters are kept: stale rows are never attended before their
        next owner rewrites them)."""
        b = self.scfg.batch
        self._queue = _PriorityQueue(self.scfg.priority_aging_s)
        self._slots: list[Request | None] = [None] * b
        self._token = np.zeros((b, 1), np.int32)
        self._positions = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        self._remaining = np.zeros((b,), np.int32)
        self._finished: dict[int, Request] = {}
        # teacher-forcing lanes: a resumed request's stored tokens, waiting
        # to be replayed through the decode chunk
        self._slot_forced: list[list[int]] = [[] for _ in range(b)]
        self.prefill_tokens = 0           # tokens run through prefill
        self.decode_chunks = 0
        self.preemptions = 0
        self._stat_samples = 0
        self._stat_running = 0
        self._stat_in_use = 0
        # prefix cache: admissions that hit, prompt tokens served from
        # cached pages against all prompt tokens admitted, COW copies
        self._prefix_hits = 0
        self._cached_prompt_tokens = 0
        self._total_prompt_tokens = 0
        self.cow_copies = 0
        self.prefix_capacity_reclaims = 0
        self.prefix_demotions = 0
        self.prefix_cold_hits = 0
        # host swap: events, and decode rows restored instead of replayed
        self.swap_outs = 0
        self.swap_ins = 0
        self.replay_steps_saved = 0
        self._t0 = time.perf_counter()
        self.prefix_cache: PrefixCache | None = None
        self.host_pool: HostPagePool | None = None
        if self._paged:
            self.allocator = PageAllocator(self._num_pages, reserved=1)
            self.page_table = PageTable(b, self._max_pages, trash_page=0,
                                        num_pages=self._num_pages,
                                        reserved=1)
            self._slot_pages: list[list[int] | None] = [None] * b
            if self._swap:
                self.host_pool = HostPagePool(
                    self.scfg.host_pages or 2 * self.allocator.capacity)
            if self.scfg.prefix_cache:
                self.prefix_cache = PrefixCache(self._page_size,
                                                self.allocator)
                if self.host_pool is not None:
                    self.prefix_cache.attach_cold_tier(
                        self._demote_page,
                        lambda hid: self.host_pool.free([hid]))

    @property
    def compile_counts(self) -> dict:
        """Distinct call signatures per stage (see ``_StageCounter``); a
        warm engine reads ``{"prefill": 1, "decode_chunk": 1}``."""
        return {name: c.count for name, c in self._stages.items()}

    @property
    def stats(self) -> dict:
        """Scheduling counters since the last ``reset``, under the
        reference's keys: ``preemptions``, ``occupancy`` (mean fraction of
        allocatable pool pages in use, sampled at each decode chunk; 0 in
        dense mode), ``concurrency`` (mean admitted requests per chunk),
        ``pool_pages``; the prefix cache's ``prefix_hits``,
        ``prefix_hit_rate`` (prompt tokens served from cached pages over
        prompt tokens admitted), ``prefill_tokens`` (tokens run through
        prefill), ``cow_copies``, ``prefix_pages`` (pages the index pins);
        the host swap's ``swap_out`` / ``swap_in`` (events),
        ``replay_steps_saved`` (decode rows restored by copy),
        ``host_pages`` (host pool size) and the cold tier's
        ``prefix_cold_pages``, ``prefix_cold_hits`` (pages promoted) and
        ``prefix_demotions``.  The keys of mechanisms not ported yet
        (speculative decoding, waves) read 0."""
        n = max(1, self._stat_samples)
        occ = (self._stat_in_use / (n * self.allocator.capacity)
               if self._paged else 0.0)
        pc, hp = self.prefix_cache, self.host_pool
        return {"preemptions": self.preemptions,
                "occupancy": occ,
                "concurrency": self._stat_running / n,
                "pool_pages": self.allocator.num_pages if self._paged else 0,
                "prefix_hits": self._prefix_hits,
                "prefix_hit_rate": (self._cached_prompt_tokens
                                    / max(1, self._total_prompt_tokens)),
                "prefill_tokens": self.prefill_tokens,
                "cow_copies": self.cow_copies,
                "prefix_pages": len(pc) if pc is not None else 0,
                "spec_rounds": 0,
                "acceptance_rate": 0.0,
                "tokens_per_step": 0.0,
                "spec_rollback_pages": 0,
                "prefill_waves": 0,
                "decode_chunks": self.decode_chunks,
                "swap_out": self.swap_outs,
                "swap_in": self.swap_ins,
                "replay_steps_saved": self.replay_steps_saved,
                "host_pages": hp.capacity if hp is not None else 0,
                "prefix_cold_pages": pc.cold_size if pc is not None else 0,
                "prefix_cold_hits": self.prefix_cold_hits,
                "prefix_demotions": self.prefix_demotions}

    @property
    def cache_token_bytes(self) -> int:
        """KV-cache bytes per cached token, summed over every layer's K
        and V; times a request's ``cache_rows`` is its cache footprint."""
        rows = (self._num_pages * self._page_size if self._paged
                else self.scfg.batch * self.scfg.max_len)
        total = sum(t.numel() * t.element_size()
                    for layer in self._caches for t in layer.values())
        return total // rows

    def _pages_for(self, req: Request) -> int:
        """Worst-case pages: prompt rows plus one row per decode step but
        the last (whose token is sampled, never written back)."""
        return pages_needed(len(req.prompt) + req.max_new_tokens - 1,
                            self._page_size)

    def _alloc_pages_for(self, req: Request) -> int:
        """Pages booked at admission: the worst case in reserve mode; the
        prompt pages plus the first decode page in incremental mode (the
        rest arrive by top-up, for resumed requests while they replay).  A
        swapped-out request in incremental mode books its ``swap_rows``
        plus the next decode row."""
        if not self._incremental:
            return self._pages_for(req)
        if req.swap_pages is not None:
            return pages_needed(req.swap_rows + 1, self._page_size)
        rows = len(req.prompt) + (1 if req.max_new_tokens > 1 else 0)
        return pages_needed(rows, self._page_size)

    # ------------------------------------------------------------------
    # host tier and prefix index
    # ------------------------------------------------------------------

    def _demote_page(self, page: int) -> int | None:
        """Cold-tier hook: copy a reclaimed device page into a fresh host
        page and return its id (``None`` when the host pool is full)."""
        hids = self.host_pool.alloc(1)
        if hids is None:
            return None
        self.host_pool.store(hids[0], extract_cache_pages(
            self._caches, [page], pad_to=self._max_pages)[0])
        self.prefix_demotions += 1
        return hids[0]

    def _promote_cold(self, keys: list, pages: list) -> None:
        """Load a run of cold prefix chunks into fresh device pages (mapped
        right behind the hot prefix, so rows keep their positions)."""
        hids = self.prefix_cache.pop_cold(keys)
        insert_cache_pages(self._caches, pages,
                           [self.host_pool.load(h) for h in hids],
                           pad_to=self._max_pages)
        self.host_pool.free(hids)
        self.prefix_cold_hits += len(pages)

    def _prefix_insert(self, keys: list, pages: list) -> None:
        """Index a prompt's chunk chain, then reclaim down to the
        ``prefix_cache_pages`` cap (best effort: pages live slots map
        are pinned)."""
        self.prefix_cache.insert(keys, pages)
        cap = self.scfg.prefix_cache_pages
        if cap and len(self.prefix_cache) > cap:
            self.prefix_capacity_reclaims += self.prefix_cache.reclaim(
                len(self.prefix_cache) - cap)

    def _prefix_plan(self, req: Request):
        """``(keys, shared_pages, cow_src, start, n_cold)`` for the longest
        usable cached prefix of ``req.prompt``; read-only (``_can_admit``
        probes it, ``_prefix_place`` re-derives it and acquires).  A fully
        covered prompt shares every page but the tail, which becomes the
        COW source: its last token must still run for its logits.  Cold
        chunks extend the hot run, except a cold tail that would cover
        the prompt (cheaper to re-prefill than to promote and copy)."""
        if req.chunk_keys is None:
            req.chunk_keys = self.prefix_cache.chunk_keys(req.prompt)
        keys = req.chunk_keys
        hits = self.prefix_cache.match(keys)
        p_len = int(req.prompt.size)
        if hits and len(hits) * self._page_size == p_len:
            return keys, hits[:-1], hits[-1], p_len - 1, 0
        n_cold = self.prefix_cache.match_cold(keys, len(hits))
        if n_cold and (len(hits) + n_cold) * self._page_size == p_len:
            n_cold -= 1
        start = (len(hits) + n_cold) * self._page_size
        return keys, hits, 0, start, n_cold

    def _admission_pages(self, req: Request) -> int:
        """Fresh pages an admission allocates: the booked count minus the
        pages served from the prefix cache (a swapped-out request restores
        its own pages, so no plan applies)."""
        booked = self._alloc_pages_for(req)
        if self.prefix_cache is None or req.swap_pages is not None:
            return booked
        return booked - len(self._prefix_plan(req)[1])

    def validate(self, prompt, max_new_tokens: int):
        """Returns ``(prompt, clamped_new_tokens, truncated)`` or raises."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        scfg = self.scfg
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt.size == 0 or prompt.size >= scfg.max_len:
            raise ValueError(f"prompt length {prompt.size} must be in "
                             f"[1, max_len={scfg.max_len})")
        if scfg.prefill_len and prompt.size > scfg.prefill_len:
            raise ValueError(f"prompt length {prompt.size} exceeds the "
                             f"slot budget prefill_len={scfg.prefill_len}")
        budget = scfg.max_len - prompt.size
        clamped = min(max_new_tokens, budget)
        if self._paged:
            need = pages_needed(prompt.size + clamped - 1, self._page_size)
            if need > self.allocator.capacity:
                raise ValueError(
                    f"request needs {need} pages but the pool capacity "
                    f"is {self.allocator.capacity}; raise num_pages or "
                    f"shorten the request")
        return prompt, clamped, max_new_tokens > budget

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0,
               priority: int = 0) -> int:
        """Queue one request; returns its id.  ``arrival`` is seconds from
        ``run()`` start; ``priority`` orders admission and preemption
        (higher first)."""
        prompt, clamped, truncated = self.validate(prompt, max_new_tokens)
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=clamped, arrival=arrival,
                      priority=priority, truncated=truncated)
        self._next_id += 1
        self._queue.push(req)
        return req.id

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _can_admit(self, req: Request) -> bool:
        """The pool must cover the request's fresh pages; with the prefix
        cache, unpinned index entries are reclaimed (never this plan's own
        hits) before deferring."""
        if not self._paged:
            return True
        need = self._admission_pages(req)
        if self.allocator.can_alloc(need):
            return True
        if self.prefix_cache is not None:
            keep = set()
            if req.swap_pages is None:
                _, shared, cow_src, _, _ = self._prefix_plan(req)
                keep = set(shared) | ({cow_src} if cow_src else set())
            self.prefix_cache.reclaim(need - self.allocator.available,
                                      keep=keep)
        return self.allocator.can_alloc(need)

    def _pick_victim(self, now: float, below: int | None = None
                     ) -> int | None:
        """Slot of the weakest runner (lowest effective priority, then the
        youngest); with ``below``, only runners strictly weaker."""
        best, best_key = None, None
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            eff = self._queue.effective(req, now)
            if below is not None and eff >= below:
                continue
            key = (eff, -req.arrival, -req.id)
            if best_key is None or key < best_key:
                best, best_key = slot, key
        return best

    def _evict(self, slot: int) -> None:
        """Preempt a runner: its pages go back to the pool and its table
        row to the trash page (before any new owner gets the pages, so
        the slot's frozen decode writes cannot reach them), and the
        request is requeued carrying every token generated so far.  With
        the host swap its live rows are first copied to host pages."""
        req = self._slots[slot]
        if self._slot_forced[slot]:
            # evicted mid-replay: splice the unreplayed tail back
            req.tokens.extend(self._slot_forced[slot])
            self._slot_forced[slot] = []
        if self._swap and req.tokens and self._slot_pages[slot]:
            # the row count is the slot's decode position, not
            # len(tokens): a mid-replay victim's spliced tokens have no
            # rows yet.  A full host pool falls back to replay.
            rows = int(self._positions[slot])
            hids = self.host_pool.alloc(pages_needed(rows, self._page_size))
            if hids is not None:
                payloads = extract_cache_pages(
                    self._caches, self._slot_pages[slot][:len(hids)],
                    pad_to=self._max_pages)
                for h, pl in zip(hids, payloads):
                    self.host_pool.store(h, pl)
                req.swap_pages = hids
                req.swap_rows = rows
                self.swap_outs += 1
        if self._paged and self._slot_pages[slot] is not None:
            self.allocator.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
            self.page_table.clear(slot)
        self._slots[slot] = None
        self._active[slot] = False
        req.preemptions += 1
        self.preemptions += 1
        self._queue.push(req)

    def _evictable_pages(self, now: float, cutoff: int) -> int:
        """Pages the pool would hold after evicting every runner strictly
        below ``cutoff``: the bound both preemption paths check first, so
        no runner is evicted for an arrival that still would not fit.
        Refcount-aware: a shared page counts once, and only when every
        holder is a would-be victim (plus, at most, the prefix index,
        whose pin reclaim can drop); index entries reclaimable now are
        added (they have no slot holder, so nothing counts twice)."""
        held: dict[int, int] = {}
        for s, r in enumerate(self._slots):
            if r is not None and self._queue.effective(r, now) < cutoff:
                for p in self._slot_pages[s] or ():
                    held[p] = held.get(p, 0) + 1
        pc = self.prefix_cache
        pinned = set(pc.pages) if pc is not None else set()
        freed = sum(1 for p, c in held.items()
                    if self.allocator.refcount(p) == c + (p in pinned))
        cold = pc.reclaimable() if pc is not None else 0
        return self.allocator.available + freed + cold

    def _admit(self, now: float) -> None:
        """Admit arrived requests into free slots, best effective priority
        first; a strictly stronger arrival blocked on a slot or on pages
        preempts the weakest runner(s)."""
        while True:
            free = next((s for s in range(self.scfg.batch)
                         if self._slots[s] is None), None)
            cand = self._queue.peek(now)
            if cand is None:
                return
            cutoff = self._queue.effective(cand, now)
            if free is None:
                # evict for the slot only if the arrival's pages are
                # coverable too
                if self._paged and (self._evictable_pages(now, cutoff)
                                    < self._admission_pages(cand)):
                    return
                victim = self._pick_victim(now, below=cutoff)
                if victim is None:
                    return
                self._evict(victim)
                continue
            req = self._queue.pop(now, admit=self._can_admit)
            if req is None:
                # backpressured on pages: evict strictly weaker runners
                # until the pool covers it, if it can
                if (self._evictable_pages(now, cutoff)
                        < self._admission_pages(cand)):
                    return
                while not self._can_admit(cand):
                    victim = self._pick_victim(now, below=cutoff)
                    if victim is None:
                        return
                    self._evict(victim)
                req = self._queue.pop(now, admit=self._can_admit)
                if req is None:
                    return
            self._place(free, req)

    def _prefix_place(self, slot: int, req: Request):
        """Prefix-cache admission: map the cached prefix read-only, book
        the remaining pages, and run the uncached suffix through the one
        prefill stage (a miss is ``start == 0``); then index the prompt's
        full chunks.  ``start`` and the COW pair are 0-d tensors, so miss,
        hit and COW share one signature.  Returns the prefill logits."""
        p_len = int(req.prompt.size)
        keys, shared, cow_src, start, n_cold = self._prefix_plan(req)
        shared = self.prefix_cache.acquire(keys[:len(shared)])
        fresh = self.allocator.alloc(self._alloc_pages_for(req)
                                     - len(shared))
        if fresh is None:             # _can_admit vouched for this plan
            raise RuntimeError("page pool changed between admission "
                               "check and placement")
        if n_cold:
            # the first fresh pages sit right behind the hot prefix
            self._promote_cold(keys[len(shared):len(shared) + n_cold],
                               fresh[:n_cold])
        cow_dst = fresh[0] if cow_src else 0
        pages = shared + fresh
        self.page_table.assign(slot, pages, shared=set(shared))
        self._slot_pages[slot] = pages
        req.cache_rows = max(req.cache_rows, len(pages) * self._page_size)
        sfx_len = p_len - start
        # the splice buffer spans every key position [0, p_len), so it
        # pads to the full prompt length, not the suffix's
        pad_len = self.scfg.prefill_len or p_len
        dev = self.device
        padded = torch.zeros((1, pad_len), dtype=torch.int64, device=dev)
        padded[0, :sfx_len] = torch.as_tensor(req.prompt[start:], device=dev)
        row = torch.as_tensor(self.page_table.row(slot), device=dev)
        args = [torch.tensor(v, dtype=torch.int64, device=dev)
                for v in (start, cow_src, cow_dst)]
        self._stages["prefill"].record(padded, row, *args)
        start_t, src_t, dst_t = args
        copy_paged_cache_page(self._caches, src_t, dst_t)
        logits, one = prefill(self.params, self.cfg, padded,
                              logits_index=sfx_len - 1,
                              ctx_caches=self._caches, ctx_table=row[None],
                              ctx_start=start_t)
        scatter_prefill_paged_caches(self._caches, one, slot, row, start_t)
        self._prefix_insert(keys, pages)
        self.prefill_tokens += sfx_len
        self._cached_prompt_tokens += start
        self._prefix_hits += bool(shared or n_cold or cow_src)
        self.cow_copies += bool(cow_src)
        return logits

    def _place(self, slot: int, req: Request) -> None:
        """Prefill a request alone into a free slot.  A fresh request
        commits its first (greedy) token; a resumed one keeps its stored
        first token and queues the rest on the slot's forcing lane.  A
        swapped-out request is restored by page copy instead."""
        if req.swap_pages is not None:
            self._swap_in(slot, req)
            return
        p_len = int(req.prompt.size)
        resumed = bool(req.tokens)
        self._total_prompt_tokens += p_len
        if self.prefix_cache is not None:
            logits = self._prefix_place(slot, req)
        else:
            logits = self._plain_place(slot, req)
        self._commit_first(slot, req, logits, resumed)

    def _plain_place(self, slot: int, req: Request):
        """Book the pages (paged) and prefill the whole prompt; returns
        the prefill logits."""
        p_len = int(req.prompt.size)
        pad_len = self.scfg.prefill_len or p_len
        row = None
        if self._paged:
            pages = self.allocator.alloc(self._alloc_pages_for(req))
            if pages is None:         # _can_admit vouched for this
                raise RuntimeError("page pool changed between admission "
                                   "check and placement")
            self.page_table.assign(slot, pages)
            self._slot_pages[slot] = pages
            req.cache_rows = max(req.cache_rows, len(pages) * self._page_size)
            grow_to = -(-pad_len // self._page_size) * self._page_size
            row = torch.as_tensor(self.page_table.row(slot),
                                  device=self.device)
        else:
            req.cache_rows = self.scfg.max_len
            grow_to = self.scfg.max_len
        padded = torch.zeros((1, pad_len), dtype=torch.int64,
                             device=self.device)
        padded[0, :p_len] = torch.as_tensor(req.prompt, device=self.device)
        self.prefill_tokens += p_len
        self._stages["prefill"].record(padded, row)
        logits, one = prefill(self.params, self.cfg, padded, max_len=grow_to,
                              logits_index=p_len - 1)
        if self._paged:
            merge_slot_paged_caches(self._caches, one, slot, row)
        else:
            merge_slot_caches(self._caches, one, slot)
        return logits

    def _commit_first(self, slot: int, req: Request, logits,
                      resumed: bool) -> None:
        """After a prefill: a fresh request commits its greedy first
        token, a resumed one keeps its stored first token and queues the
        rest on the forcing lane; then the slot starts decoding."""
        p_len = int(req.prompt.size)
        if resumed:
            tok = req.tokens[0]
            self._slot_forced[slot] = req.tokens[1:]
            req.tokens = [tok]
        else:
            self._slot_forced[slot] = []
            tok = int(torch.argmax(logits[0, -1]))
            req.tokens.append(tok)
            req.t_first = time.perf_counter() - self._t0
            req.t_tokens.append(req.t_first)
        if (req.max_new_tokens <= 1
                or (self.scfg.eos_id >= 0 and tok == self.scfg.eos_id)):
            self._finish(req, slot)
        else:
            self._slots[slot] = req
            self._token[slot, 0] = tok
            self._positions[slot] = p_len
            self._active[slot] = True
            self._remaining[slot] = req.max_new_tokens - 1

    def _swap_in(self, slot: int, req: Request) -> None:
        """Resume a swapped-out request by page copy: its rows come back
        from the host pool into fresh pages, bit for bit, and the stream
        continues at the position the eviction interrupted; tokens past
        the last row written re-enter the forcing lane."""
        p_len = int(req.prompt.size)
        pages = self.allocator.alloc(self._alloc_pages_for(req))
        if pages is None:             # _can_admit vouched for this
            raise RuntimeError("page pool changed between admission "
                               "check and placement")
        n = len(req.swap_pages)
        insert_cache_pages(self._caches, pages[:n],
                           [self.host_pool.load(h) for h in req.swap_pages],
                           pad_to=self._max_pages)
        self.host_pool.free(req.swap_pages)
        req.swap_pages = None
        self.page_table.assign(slot, pages)
        self._slot_pages[slot] = pages
        req.cache_rows = max(req.cache_rows, len(pages) * self._page_size)
        committed = req.swap_rows - p_len + 1
        self._slot_forced[slot] = list(req.tokens[committed:])
        req.tokens = req.tokens[:committed]
        self._slots[slot] = req
        self._token[slot, 0] = int(req.tokens[-1])
        self._positions[slot] = req.swap_rows
        self._active[slot] = True
        self._remaining[slot] = req.max_new_tokens - committed
        self.swap_ins += 1
        self.replay_steps_saved += req.swap_rows - p_len
        req.swap_rows = 0

    def _finish(self, req: Request, slot: int) -> None:
        req.t_done = time.perf_counter() - self._t0
        self._finished[req.id] = req
        self._slot_forced[slot] = []
        if self._paged and self._slot_pages[slot] is not None:
            # the departing slot's row re-points at the trash page, so its
            # frozen decode writes cannot touch the pages' next owner
            self.allocator.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
            self.page_table.clear(slot)

    def _top_up(self, now: float) -> None:
        """Incremental mode: before a chunk, grow every active slot whose
        writes would cross its last page; when the pool is dry, evict the
        weakest runner (possibly the needy slot itself, which then resumes
        once pages free up)."""
        for slot in range(self.scfg.batch):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            steps = min(self.scfg.decode_chunk, int(self._remaining[slot]))
            need = pages_needed(int(self._positions[slot]) + steps,
                                self._page_size)
            while need > self.page_table.live_len(slot):
                deficit = need - self.page_table.live_len(slot)
                got = self.allocator.alloc(deficit)
                if got is not None:
                    self.page_table.extend(slot, got)
                    self._slot_pages[slot].extend(got)
                    req.cache_rows = max(
                        req.cache_rows,
                        len(self._slot_pages[slot]) * self._page_size)
                    break
                # unpinned prefix pages go before any runner is evicted
                pc = self.prefix_cache
                if pc is not None and pc.reclaim(
                        deficit - self.allocator.available):
                    continue
                # never None: this slot is running, hence a candidate
                victim = self._pick_victim(now)
                self._evict(victim)
                if victim == slot:
                    break

    @torch.no_grad()
    def _decode_chunk(self, forced: np.ndarray):
        """``decode_chunk`` greedy steps on the device; inactive slots are
        frozen and emit -1.  ``forced`` (steps, B) holds replayed tokens
        (-1 = none): where set, the stored token replaces the argmax, so a
        resumed request rebuilds the KV of its uninterrupted run.  Returns
        the host copies of the chunk state and the (steps, B) emitted
        tokens and validity."""
        dev = self.device
        token = torch.as_tensor(self._token, device=dev).long()
        positions = torch.as_tensor(self._positions, device=dev).long()
        active = torch.as_tensor(self._active, device=dev)
        remaining = torch.as_tensor(self._remaining, device=dev)
        table = (torch.as_tensor(self.page_table.asarray(), device=dev)
                 if self._paged else None)
        forced = torch.as_tensor(forced, device=dev).long()
        self._stages["decode_chunk"].record(token, positions, active,
                                            remaining, table, forced)
        max_pos = self.scfg.max_len - 1
        toks, valid = [], []
        for t in range(self.scfg.decode_chunk):
            logits, _ = decode_step(self.params, self.cfg, token,
                                    self._caches, positions,
                                    page_table=table)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            nxt = torch.where(forced[t] >= 0, forced[t], nxt)
            toks.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
            valid.append(active)
            remaining = remaining - active.to(remaining.dtype)
            alive = remaining > 0
            if self.scfg.eos_id >= 0:
                alive = alive & (nxt != self.scfg.eos_id)
            positions = torch.where(
                active, torch.clamp(positions + 1, max=max_pos), positions)
            token = torch.where(active[:, None], nxt[:, None], token)
            active = active & alive
        return (token.cpu().numpy().astype(np.int32),
                positions.cpu().numpy().astype(np.int32),
                active.cpu().numpy(), remaining.cpu().numpy(),
                torch.stack(toks).cpu().numpy(),
                torch.stack(valid).cpu().numpy())

    def _run_chunk(self, now: float) -> None:
        if self._incremental:
            self._top_up(now)
            if not self._active.any():
                return                # top-up evicted the last runner
        b, nsteps = self.scfg.batch, self.scfg.decode_chunk
        forced = np.full((nsteps, b), -1, np.int32)
        for slot in range(b):
            buf = self._slot_forced[slot]
            if buf and self._slots[slot] is not None:
                n = min(nsteps, len(buf))
                forced[:n, slot] = buf[:n]
                del buf[:n]
        self._stat_samples += 1
        self._stat_running += sum(r is not None for r in self._slots)
        if self._paged:
            self._stat_in_use += self.allocator.in_use
        self.decode_chunks += 1
        (self._token, self._positions, self._active, self._remaining,
         toks, valid) = self._decode_chunk(forced)
        tnow = time.perf_counter() - self._t0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for t in range(toks.shape[0]):
                if not valid[t, slot]:
                    break
                tok = int(toks[t, slot])
                req.tokens.append(tok)
                if len(req.t_tokens) < len(req.tokens):
                    # replayed tokens keep their original stamps
                    req.t_tokens.append(tnow)
                if (len(req.tokens) >= req.max_new_tokens
                        or (self.scfg.eos_id >= 0
                            and tok == self.scfg.eos_id)):
                    self._finish(req, slot)
                    self._slots[slot] = None
                    break

    def start(self, t0: float | None = None) -> None:
        """Anchor the run clock (arrivals and latency stamps)."""
        self._t0 = time.perf_counter() if t0 is None else t0

    def step(self, wait: bool = True) -> bool:
        """Admit arrived requests, then run one decode chunk if any slot
        is active.  Returns ``False`` once nothing is queued or running."""
        if not (len(self._queue)
                or any(r is not None for r in self._slots)):
            return False
        now = time.perf_counter() - self._t0
        self._admit(now)
        if not self._active.any():
            if not len(self._queue):
                return False
            nxt = self._queue.next_arrival()
            wait_s = nxt - (time.perf_counter() - self._t0)
            if wait_s > 0:
                if wait:
                    time.sleep(min(wait_s, 0.05))
                return True
            if nxt > now:
                return True           # arrived during this _admit window
            # an arrived request went unadmitted with every slot idle: an
            # idle engine holds no pages, so this is a leak or an
            # unsatisfiable request, not backpressure
            detail = ""
            if self._paged:
                detail = (f" ({self.allocator.in_use} pages still in use, "
                          f"{self.allocator.available} free of "
                          f"{self.allocator.capacity} allocatable)")
            raise RuntimeError(
                f"serve scheduler stalled: {len(self._queue)} arrived "
                f"request(s) cannot be admitted with all slots "
                f"idle{detail}")
        self._run_chunk(time.perf_counter() - self._t0)
        return True

    def drain(self) -> dict[int, Request]:
        """Hand over (and clear) the finished-request map."""
        out, self._finished = self._finished, {}
        return out

    def run(self) -> dict[int, Request]:
        """Serve until every submitted request has finished; returns
        ``{id: Request}``."""
        self.start()
        while self.step():
            pass
        return self.drain()

    def release_prefix_cache(self) -> None:
        """Drop every reference the prefix index holds, device and host
        (teardown and leak checks)."""
        if self.prefix_cache is not None:
            self.prefix_cache.drop()

    def leaked_pages(self) -> int:
        """Pages still held after a drained run, on the device pool and
        the host pool (call ``release_prefix_cache`` first when the prefix
        cache is on); 0 in dense mode."""
        if not self._paged:
            return 0
        host = self.host_pool.in_use if self.host_pool is not None else 0
        return self.allocator.in_use + host

    def generate(self, prompts, n_new: int) -> torch.Tensor:
        """prompts: (B, S) ints -> (B, S + n_new) int32 tokens on the
        engine's device.  Lockstep wrapper over submit/run: B must equal
        the slot count and every request decodes exactly ``n_new`` tokens
        (build the engine with ``eos_id=-1``; an early EOS raises)."""
        prompts = np.asarray(torch.as_tensor(prompts).cpu(), np.int32)
        b, s = prompts.shape
        if b != self.scfg.batch:
            raise ValueError(f"prompts batch {b} != ServeConfig.batch "
                             f"{self.scfg.batch}")
        if s + n_new > self.scfg.max_len:
            raise ValueError(f"prompt_len {s} + n_new {n_new} exceeds "
                             f"max_len {self.scfg.max_len}")
        self.reset()
        ids = [self.submit(prompts[i], n_new) for i in range(b)]
        done = self.run()
        short = [i for i in ids if len(done[i].tokens) != n_new]
        if short:
            raise RuntimeError(
                f"generate() needs rectangular output but request(s) "
                f"{short} stopped at eos_id={self.scfg.eos_id} before "
                f"emitting n_new={n_new} tokens; use submit()/run() for "
                f"ragged workloads or build the engine with eos_id=-1")
        gen = np.stack([np.asarray(done[i].tokens, np.int32) for i in ids])
        return torch.as_tensor(np.concatenate([prompts, gen], axis=1),
                               device=self.device)
