"""DP serve fleet (port of ``repro.serve.router``): N engine replicas
behind one admission queue.

N independent ``Engine`` replicas sit behind a single arrival-gated
priority queue, and a host-side router decides, per arrived request,
which replica serves it:

* **Least-loaded / join-shortest-queue.**  The placement key is a
  replica's queued plus running request count.
* **Priorities.**  The router pops its queue best effective priority
  first (the engine's aging rule), so a high-priority arrival is placed
  before a low-priority one that arrived earlier, and keeps its priority
  inside the replica.
* **Prefix-cache affinity.**  With ``prefix_cache=True`` the router
  hashes each prompt's page-aligned chunk chain once
  (``paging.hash_chunks``, the keys every replica's index uses) and probes
  every replica's ``PrefixCache.match``: the replica holding the longest
  cached prefix wins; ties fall back to JSQ, then to the lowest index.
* **Fleet stats.**  ``Router.stats`` aggregates ``Engine.stats`` (summed
  counters, rates re-derived from their summed numerators and
  denominators) and adds the placement split (``per_replica``).  The
  workload driver runs a ``Router`` unchanged: it mirrors the engine's
  ``submit`` / ``run`` / ``reset`` / ``stats`` surface.

One thread drives the fleet: ``run`` round-robins ``Engine.step(wait=
False)`` over the replicas.  Requests keep their router ids; each
replica's own ids live in a disjoint block (``i * 2**20``), and since a
sampled stream's key is derived from its id, two replicas never draw
correlated streams.

The replicas share one ``params`` tree, so the weights are not copied:
by default every replica runs on ``device``, as the reference's unmeshed
replicas share its one device.  ``devices`` places replica ``i`` on
``devices[i]`` (the weights then go once to each distinct device).
Tensor parallelism inside a replica is not ported: ``ServeConfig.tp`` and
``mesh_shape`` raise in the engine.
"""

from __future__ import annotations

import time

import torch

from repro_torch import resolve_device
from repro_torch.serve.engine import Engine, Request, ServeConfig, \
    _PriorityQueue
from repro_torch.serve.paging import hash_chunks
from repro_torch.tree import tree_map

__all__ = ["Router"]

# replica-local request ids live in disjoint blocks, so the id-derived
# stream key fold_in(base_key, id) never collides across replicas
_ID_BLOCK = 1 << 20


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Router:
    """Admission router over ``replicas`` engine replicas.  Mirrors the
    engine's serving surface (``submit`` / ``run`` / ``start`` / ``step``
    / ``drain`` / ``reset`` / ``stats`` / ``compile_counts``), so the
    workload driver and the launcher drive a fleet like one engine."""

    def __init__(self, cfg, params, scfg: ServeConfig, *, replicas: int = 2,
                 device="cuda", devices=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if devices is None:
            placed = [resolve_device(device)] * replicas
        else:
            devices = [resolve_device(d) for d in devices]
            if len(devices) < replicas:
                raise ValueError(
                    f"{replicas} replicas need {replicas} devices (one "
                    f"each) but only {len(devices)} devices were given")
            placed = devices[:replicas]
        self.cfg = cfg
        self.scfg = scfg
        self.device = placed[0]
        trees = {}
        for dev in placed:
            key = str(_canonical(dev))
            if key not in trees:
                trees[key] = tree_map(
                    lambda t, dev=dev: t.to(dev)
                    if isinstance(t, torch.Tensor) else t, params)
        self.replicas = [Engine(cfg, trees[str(_canonical(dev))], scfg,
                                device=dev) for dev in placed]
        self._devices = {str(_canonical(dev)) for dev in placed}
        for i, eng in enumerate(self.replicas):
            eng._next_id = i * _ID_BLOCK
        self._prefix = bool(scfg.prefix_cache)
        self._page_size = (self.replicas[0].cfg.page_size
                           if self._prefix else 0)
        self._queue = _PriorityQueue(scfg.priority_aging_s)
        self._next_gid = 0
        self._placed: dict[int, tuple[int, int]] = {}
        self.placements = [0] * replicas
        self.affinity_hits = [0] * replicas
        self.placement_order: list[int] = []

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0,
               priority: int = 0) -> int:
        """Queue one request fleet-wide; returns its global id (the key of
        the ``run()`` result).  An unserveable request is rejected here,
        not at placement inside a replica."""
        prompt, clamped, truncated = self.replicas[0].validate(
            prompt, max_new_tokens)
        req = Request(id=self._next_gid, prompt=prompt,
                      max_new_tokens=clamped, arrival=arrival,
                      priority=priority, truncated=truncated)
        self._next_gid += 1
        self._queue.push(req)
        return req.id

    def _load(self, eng: Engine) -> int:
        """JSQ key: queued plus running requests on a replica."""
        return len(eng._queue) + sum(r is not None for r in eng._slots)

    def _pick_replica(self, req: Request) -> int:
        """Prefix affinity first (most cached chunks of this prompt), then
        least loaded, then lowest index: a total order, so placement is
        deterministic for a given fleet state."""
        keys = (hash_chunks(req.prompt, self._page_size)
                if self._prefix else None)
        best, best_key = 0, None
        for i, eng in enumerate(self.replicas):
            hits = len(eng.prefix_cache.match(keys)) if keys else 0
            key = (-hits, self._load(eng), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best_key[0] < 0:
            self.affinity_hits[best] += 1
        return best

    def _dispatch(self, req: Request) -> None:
        ri = self._pick_replica(req)
        lid = self.replicas[ri].submit(req.prompt, req.max_new_tokens,
                                       arrival=req.arrival,
                                       priority=req.priority)
        self._placed[req.id] = (ri, lid)
        self.placements[ri] += 1
        self.placement_order.append(req.id)

    # ------------------------------------------------------------------
    # fleet loop
    # ------------------------------------------------------------------

    def start(self, t0: float | None = None) -> None:
        """Anchor one run clock across every replica, so fleet latency
        percentiles pool comparable stamps."""
        self._t0 = time.perf_counter() if t0 is None else t0
        for eng in self.replicas:
            eng.start(self._t0)

    def step(self, wait: bool = True) -> bool:
        """Place every arrived request (best effective priority first),
        then give every replica one non-blocking scheduler step.  Returns
        ``False`` once the whole fleet is drained."""
        now = time.perf_counter() - self._t0
        while True:
            req = self._queue.pop(now)
            if req is None:
                break
            self._dispatch(req)
        alive = False
        for eng in self.replicas:
            alive = eng.step(wait=False) or alive
        if alive:
            return True
        if not len(self._queue):
            return False
        if wait:                       # fleet idle until the next arrival
            wait_s = (self._queue.next_arrival()
                      - (time.perf_counter() - self._t0))
            if wait_s > 0:
                time.sleep(min(wait_s, 0.05))
        return True

    def drain(self) -> dict[int, Request]:
        """Finished requests from every replica, keyed by global id."""
        drained = [eng.drain() for eng in self.replicas]
        out = {}
        for gid, (ri, lid) in list(self._placed.items()):
            req = drained[ri].get(lid)
            if req is not None:
                out[gid] = req
                del self._placed[gid]
        return out

    def run(self) -> dict[int, Request]:
        """Drain the fleet; returns ``{global_id: Request}`` with the
        engine's per-request timing contract."""
        self.start()
        while self.step():
            pass
        return self.drain()

    def reset(self, rng=None) -> None:
        for eng in self.replicas:
            eng.reset(rng)
        self._queue = _PriorityQueue(self.scfg.priority_aging_s)
        self._placed = {}
        self.placements = [0] * len(self.replicas)
        self.affinity_hits = [0] * len(self.replicas)
        self.placement_order = []

    # ------------------------------------------------------------------
    # fleet-level reporting
    # ------------------------------------------------------------------

    def _max_counts(self, name: str) -> dict:
        out: dict[str, int] = {}
        for eng in self.replicas:
            for k, v in getattr(eng, name).items():
                out[k] = max(out.get(k, 0), v)
        return out

    @property
    def compile_counts(self) -> dict:
        """Element-wise max over replicas: every replica must hold the
        per-stage pins, so the fleet reads the single-engine contract
        (``{"prefill": 1, "decode_chunk": 1}``) unless one recompiled."""
        return self._max_counts("compile_counts")

    @property
    def capture_counts(self) -> dict:
        """Element-wise max of the replicas' CUDA graph counts."""
        return self._max_counts("capture_counts")

    @property
    def stats(self) -> dict:
        """Fleet aggregation of ``Engine.stats``: counters summed, rates
        re-derived from summed numerators and denominators, occupancy the
        mean over replicas (same pool each), plus ``dp_replicas``,
        ``placements`` and ``per_replica`` (each replica's placements and
        the fraction of them that followed its prefix index)."""
        per = [eng.stats for eng in self.replicas]
        n = len(self.replicas)
        cached = sum(e._cached_prompt_tokens for e in self.replicas)
        total_p = sum(e._total_prompt_tokens for e in self.replicas)
        proposed = sum(e.spec_proposed for e in self.replicas)
        accepted = sum(e.spec_accepted for e in self.replicas)
        spec_toks = sum(e.spec_tokens for e in self.replicas)
        slot_rounds = sum(e.spec_slot_rounds for e in self.replicas)
        summed = ("preemptions", "concurrency", "pool_pages", "prefix_hits",
                  "prefill_tokens", "cow_copies", "prefix_pages",
                  "spec_rounds", "spec_rollback_pages", "prefill_waves",
                  "decode_chunks", "swap_out", "swap_in",
                  "replay_steps_saved", "host_pages", "prefix_cold_pages",
                  "prefix_cold_hits", "prefix_demotions")
        out = {k: sum(s[k] for s in per) for k in summed}
        out.update({
            "occupancy": sum(s["occupancy"] for s in per) / n,
            "prefix_hit_rate": cached / max(1, total_p),
            "acceptance_rate": accepted / max(1, proposed),
            "tokens_per_step": spec_toks / max(1, slot_rounds),
            "dp_replicas": n,
            "placements": list(self.placements),
            "per_replica": [
                {"replica": i,
                 "placed": self.placements[i],
                 "affinity_hits": self.affinity_hits[i],
                 "affinity_hit_rate": round(
                     self.affinity_hits[i] / max(1, self.placements[i]), 3),
                 "prefix_hit_rate": round(per[i]["prefix_hit_rate"], 3),
                 "preemptions": per[i]["preemptions"],
                 "occupancy": round(per[i]["occupancy"], 3),
                 "concurrency": round(per[i]["concurrency"], 2)}
                for i in range(n)],
        })
        return out

    @property
    def cache_token_bytes(self) -> int:
        return self.replicas[0].cache_token_bytes

    @property
    def mesh_shape(self) -> tuple:
        """Per-replica (data, model) mesh shape: (1, 1), one device each."""
        return (1, 1)

    @property
    def device_count(self) -> int:
        """Distinct devices the fleet spans (replicas sharing one device
        count it once)."""
        return len(self._devices)

    def release_prefix_cache(self) -> None:
        for eng in self.replicas:
            eng.release_prefix_cache()

    def leaked_pages(self) -> int:
        """Pages still booked across the replicas after a drained run
        (release the prefix caches first)."""
        return sum(eng.leaked_pages() for eng in self.replicas)
