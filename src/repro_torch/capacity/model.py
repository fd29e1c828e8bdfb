"""Analytic serving-capacity model (port of ``repro.capacity.model``).

Predicts **tok/s, TTFT p50/p99, cache footprint, steady-state
concurrency and preemption risk** for a ``(ServeConfig knobs, workload
shape)`` pair without running the model: the scheduler loop of
``repro_torch.serve.engine`` is replayed as a deterministic discrete-event
simulation in which every stage dispatch costs a constant (the
:class:`StageCosts`) instead of a real forward.  The structure (dispatch
counts, admission and eviction order, arrival gaps, page-pool occupancy)
is derived; only the per-dispatch constants are calibrated, either

* **measured** on a live engine (``repro_torch.capacity.calibrate``
  times each stage on a recorded signature), or
* **modeled** from the closed-form per-stage MACs and bytes through a
  device's peak rates (:meth:`StageCosts.from_model`, no hardware in the
  loop; what the ``--autotune`` knob search ranks settings with).  The
  rates default to the H100's (:data:`H100`).

The simulation mirrors ``Engine.step()``: arrival-gated priority
admission with the ``(eff, arrival, seq)`` order, page-pool backpressure
and eviction, reserve vs incremental booking with per-chunk top-ups,
evict-and-resume preemption with token replay (or a host-tier page swap),
the chunked and grouped wave prefill, and speculative rounds whose
per-slot emission rate is the geometric-run expectation from
``spec_math``.  The workload comes from the same seeded draw the timed
driver uses (``repro_torch.serve.workload.draw_workload``).

Everything but ``StageCosts.from_model`` is the reference's code, copied:
NumPy and plain Python, so a prediction equals the reference's for the
same inputs.  Known simplifications (the reference's): prefix-cache page
sharing is not modeled (every prompt is cold), EOS never fires, and
speculative acceptance enters as one scalar ``alpha``, accumulated
fractionally so the long-run token count is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.capacity.spec_math import expected_tokens_per_round
from repro_torch.launch.mesh import HW
from repro_torch.serve.paging import pages_needed
from repro_torch.staticcheck.flops import analytic_macs

__all__ = ["WorkloadShape", "Knobs", "StageCosts", "CapacityError", "H100",
           "predict", "analytic_cache_token_bytes"]


# the peak rates the static cost model divides work by: the roofline's
# H100 (``launch.mesh.HW``), under the name the capacity model exports
H100 = HW


class CapacityError(ValueError):
    """A knob/workload combination the engine itself would reject at
    submit time (mirrors ``Engine.validate``'s ValueError)."""


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """The workload half of the prediction input — the exact knob set
    ``run_timed_workload`` draws its request stream from."""

    requests: int
    prompt_budget: int
    new_tokens: int
    stagger_s: float = 0.0
    seed: int = 0
    priority_mix: float = 0.0
    shared_prefix: float = 0.0
    arrival_mode: str = "uniform"

    def draw(self):
        """The realized request stream (lengths/arrivals/priorities) —
        bit-identical to the timed driver's, minus the prompt bodies."""
        from repro_torch.serve.workload import draw_workload
        return draw_workload(2, requests=self.requests,
                             prompt_budget=self.prompt_budget,
                             new_tokens=self.new_tokens,
                             stagger_s=self.stagger_s, seed=self.seed,
                             priority_mix=self.priority_mix,
                             shared_prefix=self.shared_prefix,
                             arrival_mode=self.arrival_mode,
                             materialize=False)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadShape":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The ServeConfig subset the capacity model depends on — a
    JSON-stable mirror so bench rows can embed the exact knob set their
    prediction was computed from."""

    batch: int
    max_len: int
    prefill_len: int = 0
    decode_chunk: int = 8
    cache_mode: str = "dense"
    page_size: int = 8
    num_pages: int | None = None
    alloc_mode: str = "reserve"
    spec_decode: bool = False
    spec_k: int = 4
    prefill_chunk: int = 0
    admit_group: int = 1
    swap_mode: str = "off"
    host_pages: int = 0
    priority_aging_s: float = 0.0
    quant_mode: str = "dense"
    quant_backend: str = "cuda"

    @classmethod
    def from_serve_config(cls, scfg) -> "Knobs":
        return cls(batch=scfg.batch, max_len=scfg.max_len,
                   prefill_len=scfg.prefill_len,
                   decode_chunk=scfg.decode_chunk,
                   cache_mode=scfg.cache_mode, page_size=scfg.page_size,
                   num_pages=scfg.num_pages, alloc_mode=scfg.alloc_mode,
                   spec_decode=scfg.spec_decode, spec_k=scfg.spec_k,
                   prefill_chunk=scfg.prefill_chunk,
                   admit_group=scfg.admit_group, swap_mode=scfg.swap_mode,
                   host_pages=scfg.host_pages,
                   priority_aging_s=scfg.priority_aging_s,
                   quant_mode=scfg.quant_mode,
                   quant_backend=scfg.quant_backend)

    @classmethod
    def from_engine(cls, engine) -> "Knobs":
        """The knobs a built engine runs: its ServeConfig, with the
        model config's settings where the ServeConfig leaves them ``None``
        (the port's engine resolves them so; under ``spec_decode`` the
        quant mode is the draft's)."""
        cfg, draft = engine.cfg, getattr(engine, "_draft_cfg", None)
        paged = cfg.cache_mode == "paged"
        return dataclasses.replace(
            cls.from_serve_config(engine.scfg),
            quant_mode=(draft or cfg).quant_mode,
            quant_backend=cfg.quant_backend, cache_mode=cfg.cache_mode,
            page_size=cfg.page_size,
            num_pages=cfg.num_pages if paged else engine.scfg.num_pages)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Knobs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_serve_config(self, **overrides):
        """The port's ServeConfig for this knob set (spec rows get the
        standard self-speculative draft program)."""
        from repro_torch.serve.engine import ServeConfig
        kw = self.to_dict()
        if kw["spec_decode"] and "spec_quant_mode" not in overrides:
            kw["spec_quant_mode"] = (self.quant_mode
                                     if self.quant_mode != "dense"
                                     else "w8a8_nibble")
        kw.update(overrides)
        return ServeConfig(**kw)

    # --- derived geometry (identical to the engine's resolution) ------
    @property
    def paged(self) -> bool:
        return self.cache_mode == "paged"

    @property
    def wave(self) -> bool:
        return self.prefill_chunk > 0 or self.admit_group > 1

    @property
    def resolved_num_pages(self) -> int:
        """Pool size incl. the reserved trash page (0 in dense mode):
        ``num_pages`` or capacity parity with the dense slab."""
        if not self.paged:
            return 0
        return (self.num_pages
                or self.batch * (self.max_len // self.page_size) + 1)


@dataclasses.dataclass
class StageCosts:
    """Seconds per compiled-stage dispatch, plus the per-dispatch host
    overhead (scheduler walk, array conversions) and the per-*event*
    cost of a host-tier swap (extract or insert is one gather dispatch
    over all of the event's pages, so the cost is dispatch-dominated
    and flat in page count — charging per page overstates multi-page
    events several-fold on the CPU proxy).  ``source`` records
    provenance: "measured" (calibrated on a live engine), "modeled"
    (static MACs/bytes through the roofline) or "manual"."""

    prefill_s: float = 0.0
    decode_chunk_s: float = 0.0
    prefill_chunk_s: float = 0.0
    draft_s: float = 0.0
    verify_s: float = 0.0
    swap_event_s: float = 0.0
    overhead_s: float = 0.0
    source: str = "manual"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StageCosts":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_model(cls, cfg, knobs: Knobs, *,
                   prompt_budget: int | None = None,
                   dispatch_s: float = 5e-5) -> "StageCosts":
        """Static cost model: per-stage MACs in closed form
        (:func:`analytic_macs`), bytes from weight streaming plus KV
        traffic, over the :class:`H100`'s peak rates.  No hardware in the
        loop: for *ranking* knob settings, not for wall-clock validation
        (the calibrated path owns that).  The reference's rule, on the
        port's device."""
        ctb = analytic_cache_token_bytes(cfg)
        p_len = knobs.prefill_len or prompt_budget or knobs.max_len // 2

        def stage_s(tokens, kv_len, logits, n_seqs, quantized):
            macs = analytic_macs(cfg, tokens=tokens, kv_len=kv_len,
                                 logit_positions=logits,
                                 quantized=quantized)["total_macs"]
            flops = 2.0 * macs
            # weight streaming reads each token's MAC operands once;
            # the KV term covers the cache rows the dispatch attends
            io = 2.0 * macs / max(tokens, 1) + n_seqs * kv_len * ctb
            return max(flops / H100.PEAK_BF16_FLOPS,
                       io / H100.HBM_BW) + dispatch_s

        quant = knobs.quant_mode != "dense"
        spec = knobs.spec_decode
        wave_chunk = knobs.prefill_chunk or knobs.prefill_len or p_len
        out = cls(source="modeled")
        if knobs.wave:
            out.prefill_chunk_s = stage_s(
                knobs.admit_group * wave_chunk, knobs.max_len,
                knobs.admit_group * wave_chunk, knobs.admit_group, quant)
        else:
            # spec pins the prefill dense
            out.prefill_s = stage_s(p_len, p_len, 1, 1,
                                    quant and not spec)
        if spec:
            out.draft_s = stage_s(knobs.batch * knobs.spec_k,
                                  knobs.max_len,
                                  knobs.batch * knobs.spec_k,
                                  knobs.batch, quant)
            out.verify_s = stage_s(knobs.batch * (knobs.spec_k + 1),
                                   knobs.max_len,
                                   knobs.batch * (knobs.spec_k + 1),
                                   knobs.batch, False)
        else:
            out.decode_chunk_s = stage_s(
                knobs.batch * knobs.decode_chunk, knobs.max_len,
                knobs.batch * knobs.decode_chunk, knobs.batch, quant)
        return out


def analytic_cache_token_bytes(cfg) -> int:
    """Closed-form KV-cache bytes per cached token, the analytic dual of
    ``Engine.cache_token_bytes`` (which counts the live buffers):
    per attention layer two ``n_kv_heads × head_dim`` rows (int8 adds
    the per-(token, head) f32 scales), MLA layers the compressed latent
    plus the shared rope key; mamba layers have no sequence axis."""
    item = 1 if cfg.kv_cache_dtype == "int8" else 2
    total = 0
    for spec in cfg.layer_specs:
        if spec.mixer != "attn":
            continue
        if spec.attn_kind == "mla":
            total += (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        else:
            total += 2 * cfg.n_kv_heads * cfg.head_dim * item
            if cfg.kv_cache_dtype == "int8":
                total += 2 * cfg.n_kv_heads * 4
    return total


# ----------------------------------------------------------------------
# the discrete-event scheduler simulation
# ----------------------------------------------------------------------

class _SimReq:
    __slots__ = ("seq", "arrival", "prio", "p_len", "max_new",
                 "truncated", "ntok", "t_first", "t_done", "cache_rows",
                 "preemptions", "swap_rows", "swap_hp")

    def __init__(self, seq, arrival, prio, p_len, max_new, truncated):
        self.seq = seq
        self.arrival = arrival
        self.prio = prio
        self.p_len = p_len
        self.max_new = max_new
        self.truncated = truncated
        self.ntok = 0               # distinct tokens emitted so far
        self.t_first = None
        self.t_done = None
        self.cache_rows = 0
        self.preemptions = 0
        self.swap_rows = 0          # rows parked in the host tier
        self.swap_hp = 0            # host pages holding them


class _Sim:
    """Deterministic replay of ``Engine.step()`` with dispatch costs in
    place of forwards.  Every scheduling decision — admission order,
    backpressure, victim choice, top-up growth, wave lane rotation —
    follows the engine's code path for the same state."""

    MAX_ITERS = 200_000

    def __init__(self, knobs: Knobs, shape: WorkloadShape,
                 costs: StageCosts, cache_token_bytes: int,
                 acceptance: float | None):
        self.k = knobs
        self.shape = shape
        self.c = costs
        self.ctb = cache_token_bytes
        self.paged = knobs.paged
        self.incremental = knobs.alloc_mode == "incremental"
        self.wave = knobs.wave
        self.spec = knobs.spec_decode
        self.swap = knobs.swap_mode == "host"
        self._validate(knobs)
        self.ps = knobs.page_size
        self.num_pages = knobs.resolved_num_pages
        self.capacity = max(0, self.num_pages - 1)
        self.host_free = ((knobs.host_pages or 2 * self.capacity)
                          if self.swap else 0)
        self.wave_chunk = knobs.prefill_chunk or knobs.prefill_len
        self.wave_group = knobs.admit_group
        self.aging = knobs.priority_aging_s
        if self.spec:
            if acceptance is None:
                raise CapacityError(
                    "spec_decode prediction needs an acceptance rate "
                    "(calibrate one or pass an assumption)")
            self.alpha = float(min(max(acceptance, 0.0), 1.0))
        b = knobs.batch
        self.slots: list[_SimReq | None] = [None] * b
        self.active = [False] * b
        self.position = [0] * b
        self.remaining = [0] * b
        self.slot_len = [0] * b         # len(req.tokens) equivalent
        self.pending = [0] * b          # forced-replay tokens queued
        self.pages = [0] * b            # pages booked by the slot
        self.prefill_next = [-1] * b    # wave lane cursor
        self.spec_acc = [0.0] * b       # fractional spec emissions
        self.free = self.capacity
        self.queue: list[_SimReq] = []
        self.all_reqs: list[_SimReq] = []
        self.t = 0.0
        # counters mirroring engine.stats
        self.preempt = 0
        self.decode_chunks = 0
        self.prefill_waves = 0
        self.spec_rounds = 0
        self.spec_slot_rounds = 0
        self.spec_tokens = 0.0
        self.swap_out = 0
        self.swap_in = 0
        self.replay_steps_saved = 0
        self.stat_samples = 0
        self.stat_running = 0
        self.stat_in_use = 0
        self.infeasible = None

    def _validate(self, k: Knobs):
        if k.batch < 1:
            raise CapacityError(f"batch must be >= 1, got {k.batch}")
        if self.incremental and not self.paged:
            raise CapacityError("alloc_mode='incremental' requires "
                                "cache_mode='paged'")
        if self.paged:
            if k.page_size < 1:
                raise CapacityError(f"page_size must be >= 1, got "
                                    f"{k.page_size}")
            if k.max_len % k.page_size:
                raise CapacityError(f"max_len {k.max_len} must be a "
                                    f"multiple of page_size "
                                    f"{k.page_size}")
        if (self.wave or self.swap) and not self.paged:
            raise CapacityError("prefill_chunk/admit_group/swap_mode "
                                "require cache_mode='paged'")
        if self.spec and k.spec_k < 1:
            raise CapacityError(f"spec_k must be >= 1, got {k.spec_k}")
        if self.wave and not (k.prefill_chunk or k.prefill_len):
            raise CapacityError("admit_group > 1 with prefill_chunk=0 "
                                "needs prefill_len > 0")

    # --- submit-time validation (Engine.validate) ---------------------
    def submit_all(self):
        draw = self.shape.draw()
        eff = draw.eff_lens
        for i in range(self.shape.requests):
            p_len = int(eff[i])
            if p_len == 0 or p_len >= self.k.max_len:
                raise CapacityError(
                    f"prompt length {p_len} must be in [1, "
                    f"max_len={self.k.max_len})")
            if self.k.prefill_len and p_len > self.k.prefill_len:
                raise CapacityError(
                    f"prompt length {p_len} exceeds the slot budget "
                    f"prefill_len={self.k.prefill_len}")
            budget = self.k.max_len - p_len
            clamped = min(self.shape.new_tokens, budget)
            if self.paged:
                need = pages_needed(p_len + clamped - 1, self.ps)
                if need > self.capacity:
                    raise CapacityError(
                        f"request needs {need} pages but the pool "
                        f"capacity is {self.capacity}")
            req = _SimReq(
                seq=i, arrival=float(draw.arrivals[i]),
                prio=int(draw.prios[i]), p_len=p_len, max_new=clamped,
                truncated=self.shape.new_tokens > budget)
            self.queue.append(req)
            self.all_reqs.append(req)

    # --- queue / priority helpers (mirror _PriorityQueue) -------------
    def _eff(self, req: _SimReq, now: float) -> int:
        if self.aging <= 0:
            return req.prio
        return req.prio + int(max(0.0, now - req.arrival) / self.aging)

    def _peek(self, now: float) -> _SimReq | None:
        best, bkey = None, None
        for r in self.queue:
            if r.arrival > now:
                continue
            key = (-self._eff(r, now), r.arrival, r.seq)
            if bkey is None or key < bkey:
                best, bkey = r, key
        return best

    # --- paging helpers (mirror Engine._pages_for etc.) ---------------
    def _pages_for(self, req: _SimReq) -> int:
        return pages_needed(req.p_len + req.max_new - 1, self.ps)

    def _alloc_pages_for(self, req: _SimReq) -> int:
        if not self.incremental:
            return self._pages_for(req)
        if req.swap_rows:
            return pages_needed(req.swap_rows + 1, self.ps)
        rows = req.p_len + (1 if req.max_new > 1 else 0)
        return pages_needed(rows, self.ps)

    def _can_admit(self, req: _SimReq) -> bool:
        if not self.paged:
            return True
        return self.free >= self._alloc_pages_for(req)

    def _evictable_pages(self, now: float, cutoff: int) -> int:
        freed = sum(self.pages[s] for s, r in enumerate(self.slots)
                    if r is not None and self._eff(r, now) < cutoff)
        return self.free + freed

    def _pick_victim(self, now: float, below: int | None = None
                     ) -> int | None:
        best, bkey = None, None
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            eff = self._eff(r, now)
            if below is not None and eff >= below:
                continue
            key = (eff, -r.arrival, -r.seq)
            if bkey is None or key < bkey:
                best, bkey = s, key
        return best

    def _evict(self, slot: int, now: float) -> None:
        req = self.slots[slot]
        if self.pending[slot]:
            # mid-replay: the unreplayed tail rides back on the request
            self.pending[slot] = 0
        if self.wave and self.prefill_next[slot] >= 0:
            self.prefill_next[slot] = -1      # restart prompt on resume
        elif self.swap and req.ntok and self.pages[slot]:
            rows = self.position[slot]
            hp = pages_needed(rows, self.ps)
            if self.host_free >= hp:
                self.host_free -= hp
                req.swap_rows = rows
                req.swap_hp = hp
                self.swap_out += 1
                self.t += self.c.swap_event_s
        self.free += self.pages[slot]
        self.pages[slot] = 0
        self.slots[slot] = None
        self.active[slot] = False
        req.preemptions += 1
        self.preempt += 1
        self.queue.append(req)

    # --- admission (mirror Engine._admit/_place) ----------------------
    def _admit(self, now: float) -> None:
        while True:
            free_slot = next((s for s in range(self.k.batch)
                              if self.slots[s] is None), None)
            cand = self._peek(now)
            if cand is None:
                return
            cutoff = self._eff(cand, now)
            if free_slot is None:
                if self.paged and (self._evictable_pages(now, cutoff)
                                   < self._alloc_pages_for(cand)):
                    return
                victim = self._pick_victim(now, below=cutoff)
                if victim is None:
                    return
                self._evict(victim, now)
                continue
            if not self._can_admit(cand):
                if (self._evictable_pages(now, cutoff)
                        < self._alloc_pages_for(cand)):
                    return
                while not self._can_admit(cand):
                    victim = self._pick_victim(now, below=cutoff)
                    if victim is None:
                        return
                    self._evict(victim, now)
            self.queue.remove(cand)
            self._place(free_slot, cand, now)

    def _book(self, slot: int, req: _SimReq) -> None:
        n = self._alloc_pages_for(req)
        self.free -= n
        self.pages[slot] = n
        req.cache_rows = max(req.cache_rows, n * self.ps)

    def _place(self, slot: int, req: _SimReq, now: float) -> None:
        if req.swap_rows:
            self._swap_in(slot, req)
            return
        if self.wave:
            self._book(slot, req)
            self.slots[slot] = req
            self.prefill_next[slot] = 0
            self.active[slot] = False
            return
        if self.paged:
            self._book(slot, req)
        else:
            req.cache_rows = self.k.max_len
        # one serialized monolithic prefill dispatch
        self.t += self.c.prefill_s + self.c.overhead_s
        resumed = req.ntok > 0
        if resumed:
            self.pending[slot] = req.ntok - 1
        else:
            self.pending[slot] = 0
            req.ntok = 1
            req.t_first = self.t
        self.slot_len[slot] = 1
        if req.max_new <= 1:
            self._finish(req, slot)
            return
        self.slots[slot] = req
        self.position[slot] = req.p_len
        self.active[slot] = True
        self.remaining[slot] = req.max_new - 1

    def _swap_in(self, slot: int, req: _SimReq) -> None:
        n = self._alloc_pages_for(req)
        self.free -= n
        self.pages[slot] = n
        req.cache_rows = max(req.cache_rows, n * self.ps)
        self.t += self.c.swap_event_s
        self.host_free += req.swap_hp
        committed = req.swap_rows - req.p_len + 1
        self.pending[slot] = req.ntok - committed
        self.slot_len[slot] = committed
        self.slots[slot] = req
        self.position[slot] = req.swap_rows
        self.active[slot] = True
        self.remaining[slot] = req.max_new - committed
        self.swap_in += 1
        self.replay_steps_saved += req.swap_rows - req.p_len
        req.swap_rows = 0
        req.swap_hp = 0

    def _finish(self, req: _SimReq, slot: int | None) -> None:
        req.t_done = self.t
        req.ntok = max(req.ntok, req.max_new)
        if slot is not None:
            self.pending[slot] = 0
            self.free += self.pages[slot]
            self.pages[slot] = 0
            self.slots[slot] = None
            self.active[slot] = False

    # --- wave prefill (mirror _run_wave/_wave_finish) -----------------
    def _run_wave(self) -> None:
        lanes = [s for s in range(self.k.batch)
                 if self.prefill_next[s] >= 0][:self.wave_group]
        self.prefill_waves += 1
        self.t += self.c.prefill_chunk_s + self.c.overhead_s
        for s in lanes:
            req = self.slots[s]
            st = self.prefill_next[s]
            n = min(self.wave_chunk, req.p_len - st)
            nxt = st + n
            if nxt >= req.p_len:
                # _wave_finish epilogue
                self.prefill_next[s] = -1
                resumed = req.ntok > 0
                if resumed:
                    self.pending[s] = req.ntok - 1
                else:
                    self.pending[s] = 0
                    req.ntok = 1
                    req.t_first = self.t
                self.slot_len[s] = 1
                if req.max_new <= 1:
                    self._finish(req, s)
                    continue
                self.position[s] = req.p_len
                self.active[s] = True
                self.remaining[s] = req.max_new - 1
            else:
                self.prefill_next[s] = nxt

    # --- decode (mirror _top_up/_run_chunk/_run_spec_round) -----------
    def _top_up(self, now: float) -> None:
        chunk_steps = (self.k.spec_k + 1 if self.spec
                       else self.k.decode_chunk)
        for slot in range(self.k.batch):
            req = self.slots[slot]
            if req is None or not self.active[slot]:
                continue
            steps = min(chunk_steps, self.remaining[slot])
            need = pages_needed(self.position[slot] + steps, self.ps)
            while need > self.pages[slot]:
                deficit = need - self.pages[slot]
                if self.free >= deficit:
                    self.free -= deficit
                    self.pages[slot] += deficit
                    req.cache_rows = max(req.cache_rows,
                                         self.pages[slot] * self.ps)
                    break
                victim = self._pick_victim(now)
                self._evict(victim, now)
                if victim == slot:
                    break

    def _sample_stats(self) -> None:
        self.stat_samples += 1
        self.stat_running += sum(r is not None for r in self.slots)
        if self.paged:
            self.stat_in_use += self.capacity - self.free

    def _emit(self, slot: int, n: int) -> None:
        """Commit ``n`` tokens to the slot's stream: replays first (no
        new emissions), fresh tokens extend the request."""
        req = self.slots[slot]
        self.pending[slot] -= min(self.pending[slot], n)
        self.slot_len[slot] += n
        self.remaining[slot] -= n
        if self.slot_len[slot] > req.ntok:
            req.ntok = self.slot_len[slot]
        if self.slot_len[slot] >= req.max_new:
            self._finish(req, slot)

    def _run_chunk(self, now: float) -> None:
        if self.incremental:
            self._top_up(now)
            if not any(self.active):
                return
        self._sample_stats()
        self.decode_chunks += 1
        self.t += self.c.decode_chunk_s + self.c.overhead_s
        for slot in range(self.k.batch):
            if self.slots[slot] is None or not self.active[slot]:
                continue
            n = min(self.k.decode_chunk, self.remaining[slot])
            self.position[slot] += n
            self._emit(slot, n)

    def _run_spec_round(self, now: float) -> None:
        if self.incremental:
            self._top_up(now)
            if not any(self.active):
                return
        self._sample_stats()
        self.spec_rounds += 1
        k = self.k.spec_k
        self.t += self.c.draft_s + self.c.verify_s + self.c.overhead_s
        for slot in range(self.k.batch):
            if self.slots[slot] is None or not self.active[slot]:
                continue
            self.spec_slot_rounds += 1
            r = self.remaining[slot]
            p = self.pending[slot]
            if p > k:
                # every draft position replays committed history and the
                # bonus is withheld (more_forced)
                e = min(k, r)
            else:
                # forced prefix force-accepts, fresh tail is geometric;
                # the fractional expectation accumulates so the long-run
                # token count is exact
                e_f = p + expected_tokens_per_round(self.alpha, k - p) \
                    if p < k else float(k + 1)
                self.spec_acc[slot] += e_f
                e = int(self.spec_acc[slot])
                e = max(1, min(e, k + 1, r))
                self.spec_acc[slot] -= e
            self.spec_tokens += e
            self.position[slot] += e
            self._emit(slot, e)
            # _spec_rollback: truncate the tail pages the top-up booked
            # past the accepted rows
            if (self.incremental and self.slots[slot] is not None):
                keep = pages_needed(self.position[slot], self.ps)
                if keep < self.pages[slot]:
                    self.free += self.pages[slot] - keep
                    self.pages[slot] = keep

    # --- the loop (mirror Engine.step/run) ----------------------------
    def run(self) -> None:
        self.submit_all()
        for _ in range(self.MAX_ITERS):
            if not self.queue and all(r is None for r in self.slots):
                return
            now = self.t
            self._admit(now)
            prefilling = self.wave and any(p >= 0
                                           for p in self.prefill_next)
            if not any(self.active) and not prefilling:
                if not self.queue:
                    return
                nxt = min(r.arrival for r in self.queue)
                if nxt > self.t:
                    self.t = nxt
                    continue
                self.infeasible = (
                    f"scheduler stall: {len(self.queue)} arrived "
                    f"request(s) cannot be admitted with all slots "
                    f"idle ({self.capacity - self.free} pages in use, "
                    f"{self.free} free of {self.capacity})")
                return
            now = self.t
            if prefilling:
                self._run_wave()
            if any(self.active):
                if self.spec:
                    self._run_spec_round(now)
                else:
                    self._run_chunk(now)
        self.infeasible = (f"no convergence after {self.MAX_ITERS} "
                           f"scheduler iterations")

    # --- report -------------------------------------------------------
    def report(self) -> dict:
        done = [r for r in self.all_reqs if r.t_done is not None]
        out = {
            "feasible": self.infeasible is None,
            "infeasible_reason": self.infeasible,
            "requests": self.shape.requests,
            "tokens": int(sum(r.ntok for r in self.all_reqs)),
            "wall_s": self.t,
            "pool_pages": self.num_pages,
            "preemptions": self.preempt,
            "preemption_risk": self.preempt / max(1, len(self.all_reqs)),
            "decode_chunks": self.decode_chunks,
            "prefill_waves": self.prefill_waves,
            "spec_rounds": self.spec_rounds,
            "tokens_per_step": (self.spec_tokens
                                / max(1, self.spec_slot_rounds)),
            "swap_out": self.swap_out,
            "swap_in": self.swap_in,
            "replay_steps_saved": self.replay_steps_saved,
            "concurrency": self.stat_running / max(1, self.stat_samples),
            "occupancy": (self.stat_in_use
                          / max(1, self.stat_samples * self.capacity)
                          if self.paged else 0.0),
            "truncated": int(sum(r.truncated for r in self.all_reqs)),
        }
        if done and self.infeasible is None:
            lat = np.asarray([r.t_done - r.arrival for r in done])
            ttft = np.asarray([r.t_first - r.arrival for r in done
                               if r.t_first is not None])
            rows = np.asarray([float(r.cache_rows) for r in done])
            wall = max(self.t, 1e-12)
            out.update({
                "tok_per_s": out["tokens"] / wall,
                "req_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "req_p99_ms": float(np.percentile(lat, 99)) * 1e3,
                "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
                "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
                "cache_kb_per_req": float(rows.mean()) * self.ctb
                / 1024.0,
            })
        return out


def predict(knobs: Knobs | object, shape: WorkloadShape,
            costs: StageCosts, *, cache_token_bytes: int = 0,
            acceptance: float | None = None) -> dict:
    """Predict serving capacity for one knob/workload pair.

    ``knobs`` may be a :class:`Knobs` or a real ``ServeConfig``.
    Returns the prediction dict (the reference's keys and semantics);
    raises :class:`CapacityError` for combinations the
    engine itself would reject, and reports scheduler-stall
    infeasibility via ``feasible=False`` instead of raising (the
    autotuner filters on it)."""
    if not isinstance(knobs, Knobs):
        knobs = Knobs.from_serve_config(knobs)
    sim = _Sim(knobs, shape, costs, cache_token_bytes, acceptance)
    sim.run()
    return sim.report()
