"""Slot-based continuous-batching serve engine (core slice of
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
* **Paged KV cache** with ``alloc_mode="reserve"``: admission books a
  request's worst-case pages from a ``PageAllocator`` and defers
  (backpressure) when the pool cannot cover them.
* **Priority queue** with optional aging, as in the reference.

Not ported yet (the knobs raise ``NotImplementedError``): sampling with
``temperature > 0`` (the reference draws from threefry keys that no other
framework reproduces), incremental allocation and preemption, prefix
caching, speculative decoding, chunked / grouped prefill, the host swap
tier and tensor parallelism.  The reference's compile counters have no
counterpart: PyTorch runs eagerly.
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
    decode_step,
    init_caches,
    merge_slot_caches,
    merge_slot_paged_caches,
    prefill,
)
from repro_torch.serve.paging import PageAllocator, PageTable, pages_needed

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
    alloc_mode: str = "reserve"       # paged page accounting
    # reference knobs outside this slice: non-default values raise
    prefix_cache: bool = False
    spec_decode: bool = False
    prefill_chunk: int = 0
    admit_group: int = 1
    swap_mode: str = "off"
    tp: int = 1
    mesh_shape: tuple | None = None


_UNPORTED = (("temperature", 0.0), ("prefix_cache", False),
             ("spec_decode", False), ("prefill_chunk", 0),
             ("admit_group", 1), ("swap_mode", "off"), ("tp", 1),
             ("mesh_shape", None))


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
    t_tokens: list = dataclasses.field(default_factory=list)
    cache_rows: int = 0               # cache rows reserved for the request
    truncated: bool = False           # max_new_tokens cut to fit max_len


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
        """Aging-adjusted priority."""
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


class Engine:
    """Continuous-batching greedy engine over a dense or paged KV cache.
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
        if scfg.alloc_mode == "incremental":
            raise NotImplementedError("alloc_mode='incremental' (and "
                                      "preemption) is not ported yet")
        if scfg.alloc_mode != "reserve":
            raise ValueError(f"alloc_mode must be 'reserve' or "
                             f"'incremental', got {scfg.alloc_mode!r}")
        if scfg.prefill_len > scfg.max_len:
            raise ValueError(f"prefill_len {scfg.prefill_len} exceeds "
                             f"max_len {scfg.max_len}")
        if scfg.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{scfg.decode_chunk}")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self._paged = cfg.cache_mode == "paged"
        if self._paged:
            ps = cfg.page_size
            if ps < 1:
                raise ValueError(f"page_size must be >= 1, got {ps}")
            if scfg.max_len % ps:
                raise ValueError(f"max_len {scfg.max_len} must be a "
                                 f"multiple of page_size {ps}")
            self._page_size = ps
            self._max_pages = scfg.max_len // ps
            self._num_pages = cfg.num_pages or scfg.batch * self._max_pages + 1
            self.cfg = cfg.replace(num_pages=self._num_pages)
        elif cfg.cache_mode != "dense":
            raise ValueError(f"cache_mode must be 'dense' or 'paged', got "
                             f"{cfg.cache_mode!r}")
        self._caches = init_caches(self.cfg, scfg.batch, scfg.max_len,
                                   device=self.device)
        self._next_id = 0
        self.reset()

    # ------------------------------------------------------------------
    # host-side state
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Clear queue and slots (cache buffers are kept: stale rows are
        never attended before their next owner rewrites them)."""
        b = self.scfg.batch
        self._queue = _PriorityQueue(self.scfg.priority_aging_s)
        self._slots: list[Request | None] = [None] * b
        self._token = np.zeros((b, 1), np.int32)
        self._positions = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        self._remaining = np.zeros((b,), np.int32)
        self._finished: dict[int, Request] = {}
        self.prefill_tokens = 0
        self.decode_chunks = 0
        self._t0 = time.perf_counter()
        if self._paged:
            self.allocator = PageAllocator(self._num_pages, reserved=1)
            self.page_table = PageTable(b, self._max_pages, trash_page=0,
                                        num_pages=self._num_pages,
                                        reserved=1)
            self._slot_pages: list[list[int] | None] = [None] * b

    def _pages_for(self, req: Request) -> int:
        """Worst-case pages: prompt rows plus one row per decode step but
        the last (whose token is sampled, never written back)."""
        return pages_needed(len(req.prompt) + req.max_new_tokens - 1,
                            self._page_size)

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
        ``run()`` start; ``priority`` orders admission (higher first)."""
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
        return (not self._paged
                or self.allocator.can_alloc(self._pages_for(req)))

    def _admit(self, now: float) -> None:
        """Admit arrived requests into free slots, best priority first.
        Where the reference would preempt a strictly weaker runner for a
        blocked arrival, this slice raises: preemption is not ported."""
        while True:
            free = next((s for s in range(self.scfg.batch)
                         if self._slots[s] is None), None)
            cand = self._queue.peek(now)
            if cand is None:
                return
            blocked = free is None or not self._can_admit(cand)
            if blocked:
                cutoff = self._queue.effective(cand, now)
                if any(r is not None
                       and self._queue.effective(r, now) < cutoff
                       for r in self._slots):
                    raise NotImplementedError(
                        "a higher-priority arrival would preempt a running "
                        "request; preemption is not ported yet")
                return
            req = self._queue.pop(now, admit=self._can_admit)
            self._place(free, req)

    def _place(self, slot: int, req: Request) -> None:
        """Prefill a request alone into a free slot and commit its first
        (greedy) token."""
        p_len = int(req.prompt.size)
        pad_len = self.scfg.prefill_len or p_len
        if self._paged:
            pages = self.allocator.alloc(self._pages_for(req))
            self.page_table.assign(slot, pages)
            self._slot_pages[slot] = pages
            req.cache_rows = len(pages) * self._page_size
            grow_to = -(-pad_len // self._page_size) * self._page_size
        else:
            req.cache_rows = self.scfg.max_len
            grow_to = self.scfg.max_len
        padded = torch.zeros((1, pad_len), dtype=torch.int64,
                             device=self.device)
        padded[0, :p_len] = torch.as_tensor(req.prompt, device=self.device)
        self.prefill_tokens += p_len
        logits, one = prefill(self.params, self.cfg, padded, max_len=grow_to,
                              logits_index=p_len - 1)
        if self._paged:
            merge_slot_paged_caches(self._caches, one, slot,
                                    torch.as_tensor(self.page_table.row(slot),
                                                    device=self.device))
        else:
            merge_slot_caches(self._caches, one, slot)
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

    def _finish(self, req: Request, slot: int) -> None:
        req.t_done = time.perf_counter() - self._t0
        self._finished[req.id] = req
        if self._paged and self._slot_pages[slot] is not None:
            # the departing slot's row re-points at the trash page, so its
            # frozen decode writes cannot touch the pages' next owner
            self.allocator.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
            self.page_table.clear(slot)

    @torch.no_grad()
    def _decode_chunk(self):
        """``decode_chunk`` greedy steps on the device; inactive slots are
        frozen and emit -1.  Returns the host copies of the chunk state
        and the (steps, B) emitted tokens and validity."""
        dev = self.device
        token = torch.as_tensor(self._token, device=dev).long()
        positions = torch.as_tensor(self._positions, device=dev).long()
        active = torch.as_tensor(self._active, device=dev)
        remaining = torch.as_tensor(self._remaining, device=dev)
        table = (torch.as_tensor(self.page_table.asarray(), device=dev)
                 if self._paged else None)
        max_pos = self.scfg.max_len - 1
        toks, valid = [], []
        for _ in range(self.scfg.decode_chunk):
            logits, _ = decode_step(self.params, self.cfg, token,
                                    self._caches, positions,
                                    page_table=table)
            nxt = torch.argmax(logits[:, -1], dim=-1)
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

    def _run_chunk(self) -> None:
        self.decode_chunks += 1
        (self._token, self._positions, self._active, self._remaining,
         toks, valid) = self._decode_chunk()
        tnow = time.perf_counter() - self._t0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for t in range(toks.shape[0]):
                if not valid[t, slot]:
                    break
                tok = int(toks[t, slot])
                req.tokens.append(tok)
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
            detail = ""
            if self._paged:
                detail = (f" ({self.allocator.in_use} pages still in use, "
                          f"{self.allocator.available} free of "
                          f"{self.allocator.capacity} allocatable)")
            raise RuntimeError(
                f"serve scheduler stalled: {len(self._queue)} arrived "
                f"request(s) cannot be admitted with all slots "
                f"idle{detail}")
        self._run_chunk()
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

    def leaked_pages(self) -> int:
        """Pages still held after a drained run (0 in dense mode)."""
        return self.allocator.in_use if self._paged else 0
