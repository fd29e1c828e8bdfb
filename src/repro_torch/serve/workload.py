"""Timed request-level workload driver for the serve engine (port of
``repro.serve.workload``).

The serving launcher (``repro_torch.launch.serve --workload
uniform|staggered|bursty``) runs it, so the warm-up protocol and the
latency definitions are the reference's:

* warm-up: one short request end to end per engine replica (on the card,
  the kernels' first use builds them; a ``Router`` places one on each
  idle replica), timed apart as ``compile_s``, then ``engine.reset()``;
* request latency = arrival -> completion; TTFT = arrival -> first token;
  ITL = gaps between consecutive emission stamps (``Request.t_tokens``),
  pooled across requests; replayed tokens keep their first stamps;
* ``tok_per_s`` counts generated tokens over the timed ``run()`` wall
  clock (arrival gaps included for staggered and bursty traffic);
* ``cache_kb_per_req`` is the mean per-request cache reservation (dense:
  the ``max_len`` slab; paged: peak pages x page_size) times the engine's
  bytes per cached token;
* ``priority_mix`` marks that fraction of requests priority 1 and splits
  request latency per class; ``shared_prefix`` gives that fraction a
  common head of ``prompt_budget // 2`` tokens;
* ``arrival_mode="bursty"`` clusters arrivals into Poisson bursts at the
  same mean load and draws prompt lengths from a clipped Pareto tail;
* scheduling counters come from ``engine.stats``: ``preemptions``,
  ``occupancy`` (mean fraction of pool pages in use per decode chunk) and
  ``concurrency`` (mean admitted requests per chunk), the prefix cache's
  ``prefix_hit_rate`` and ``prefill_tokens``, the host swap's
  ``swap_out``, ``swap_in``, ``replay_steps_saved`` and
  ``prefix_cold_hits``, plus ``truncated``.

``draw_workload`` is the reference's numpy draw, copied, so a seed gives
the same arrays in both packages.  The topology keys (``device_count``,
``mesh_shape``, ``dp_replicas``) come from the engine or the fleet, and a
``Router``'s result carries its ``per_replica`` placement split.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["WorkloadDraw", "draw_workload", "run_timed_workload"]


def _pct(a, q) -> float | None:
    """Percentile that survives an empty sample: ``None`` instead of
    numpy's NaN-with-RuntimeWarning.  Per-class latency splits hit this
    whenever a priority class drew zero requests (priority_mix near 0
    or 1 with few requests)."""
    if a is None or len(a) == 0:
        return None
    return float(np.percentile(a, q))


def _ms(x: float | None, digits: int = 1) -> float | None:
    """Seconds → rounded milliseconds, passing ``None`` through."""
    return None if x is None else round(x * 1e3, digits)


@dataclasses.dataclass
class WorkloadDraw:
    """One fully-drawn workload: a pure function of ``(seed, knobs)``,
    array for array the reference's draw (whose capacity model reads the
    same arrays), so both packages drive their engines with one stream."""

    lens: np.ndarray            # drawn prompt lengths (pre shared-head)
    arrivals: np.ndarray        # arrival offsets, seconds from t=0
    prios: np.ndarray           # 0/1 priority class per request
    shared: np.ndarray          # bool: carries the shared system head
    sys_len: int                # shared system-prompt head length
    prompts: list | None        # token arrays (None when not drawn)

    @property
    def eff_lens(self) -> np.ndarray:
        """Effective prompt lengths as submitted: a shared-head prompt
        is re-drawn to at least ``sys_len + 1`` tokens."""
        return np.where(self.shared,
                        np.maximum(self.lens, self.sys_len + 1),
                        self.lens).astype(np.int64)

    def summary(self, new_tokens: int) -> dict:
        """Workload-shape summary for result rows: the realized
        length/arrival distribution behind the percentile columns."""
        eff = self.eff_lens
        span = float(self.arrivals.max() - self.arrivals.min())
        return {
            "prompt_len_mean": round(float(eff.mean()), 2),
            "prompt_len_max": int(eff.max()),
            "prompt_tokens": int(eff.sum()),
            "decode_tokens": int(len(eff) * new_tokens),
            "arrival_span_s": round(span, 3),
            "peak_burst": int(np.max(np.unique(self.arrivals,
                                               return_counts=True)[1])),
        }


def _validate_workload(requests: int, prompt_budget: int,
                       new_tokens: int, priority_mix: float,
                       shared_prefix: float, arrival_mode: str) -> None:
    # validate up front: requests == 0 crashes the percentile math and
    # prompt_budget < 2 turns the rng.integers bounds inside out
    # (low = max(2, budget // 2) would exceed high = budget + 1)
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    if prompt_budget < 2:
        raise ValueError(f"prompt_budget must be >= 2 (prompt lengths are "
                         f"drawn from [max(2, prompt_budget // 2), "
                         f"prompt_budget]), got {prompt_budget}")
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    if not 0.0 <= priority_mix <= 1.0:
        raise ValueError(f"priority_mix must be in [0, 1], got "
                         f"{priority_mix}")
    if not 0.0 <= shared_prefix <= 1.0:
        raise ValueError(f"shared_prefix must be in [0, 1], got "
                         f"{shared_prefix}")
    if arrival_mode not in ("uniform", "bursty"):
        raise ValueError(f"arrival_mode must be 'uniform' or 'bursty', "
                         f"got {arrival_mode!r}")


def draw_workload(vocab_size: int, *, requests: int, prompt_budget: int,
                  new_tokens: int = 1, stagger_s: float = 0.0,
                  seed: int = 0, priority_mix: float = 0.0,
                  shared_prefix: float = 0.0,
                  arrival_mode: str = "uniform",
                  materialize: bool = True) -> WorkloadDraw:
    """Draw the whole workload — lengths, arrivals, priorities, shared
    mask and (when ``materialize``) the prompt token arrays — from one
    seeded rng.  ``arrival_mode="uniform"`` spaces arrivals
    ``stagger_s`` apart with lengths uniform in
    [prompt_budget/2, prompt_budget]; ``"bursty"`` keeps the same mean
    offered load but clusters arrivals into Poisson bursts and draws
    lengths from a clipped Pareto(1.5) heavy tail.

    The draw order is frozen: lens → arrivals → prios → shared mask →
    system head → prompt bodies.  ``materialize=False`` stops before
    the prompt bodies — everything a scheduler simulation needs is
    already drawn, bit-identical to the driver's stream."""
    _validate_workload(requests, prompt_budget, new_tokens, priority_mix,
                       shared_prefix, arrival_mode)
    rng = np.random.default_rng(seed)
    if arrival_mode == "uniform":
        lens = rng.integers(max(2, prompt_budget // 2), prompt_budget + 1,
                            requests)
        arrivals = np.arange(requests) * stagger_s
    else:
        # heavy-tail lengths: Pareto(1.5) scaled so the typical prompt
        # sits near prompt_budget/2 but a fat tail pins the budget cap
        lens = np.clip(
            (2 + rng.pareto(1.5, requests) * (prompt_budget // 4))
            .astype(np.int64), 2, prompt_budget)
        # Poisson bursts at the same mean load as uniform spacing:
        # burst sizes ~ geometric (mean _BURST_MEAN, simultaneous
        # arrivals inside a burst), exponential inter-burst gaps with
        # mean burst_size × stagger_s
        _BURST_MEAN = 3
        arrivals = np.zeros(requests)
        t, i = 0.0, 0
        while i < requests:
            size = min(int(rng.geometric(1.0 / _BURST_MEAN)),
                       requests - i)
            arrivals[i:i + size] = t
            i += size
            t += rng.exponential(_BURST_MEAN * stagger_s) \
                if stagger_s > 0 else 0.0
    prios = (rng.random(requests) < priority_mix).astype(np.int32)
    shared = rng.random(requests) < shared_prefix
    sys_prompt = rng.integers(0, vocab_size, prompt_budget // 2)

    def make_prompt(i):
        n = int(lens[i])
        if not shared[i]:
            return rng.integers(0, vocab_size, n)
        # shared head + ≥1 private token so every prompt stays distinct
        # from the bare system prompt (lengths are re-drawn up to the
        # budget, never past it)
        n = max(n, sys_prompt.size + 1)
        tail = rng.integers(0, vocab_size, n - sys_prompt.size)
        return np.concatenate([sys_prompt, tail])

    prompts = ([make_prompt(i) for i in range(requests)]
               if materialize else None)
    return WorkloadDraw(lens=lens, arrivals=arrivals, prios=prios,
                        shared=shared, sys_len=int(sys_prompt.size),
                        prompts=prompts)


def run_timed_workload(engine, vocab_size: int, *, requests: int,
                       prompt_budget: int, new_tokens: int,
                       stagger_s: float = 0.0, seed: int = 0,
                       priority_mix: float = 0.0,
                       shared_prefix: float = 0.0,
                       arrival_mode: str = "uniform",
                       collect_streams: bool = False) -> dict:
    """Submit ``requests`` prompts drawn by :func:`draw_workload` and
    drain the engine; returns throughput, latency and scheduling stats
    under the reference's keys (``streams`` too with
    ``collect_streams``, keyed by submission index)."""
    # the workload is drawn before the warm-up, so it is a pure function
    # of (seed, knobs)
    draw = draw_workload(vocab_size, requests=requests,
                         prompt_budget=prompt_budget,
                         new_tokens=new_tokens, stagger_s=stagger_s,
                         seed=seed, priority_mix=priority_mix,
                         shared_prefix=shared_prefix,
                         arrival_mode=arrival_mode)
    lens, arrivals, prios = draw.lens, draw.arrivals, draw.prios
    prompts = draw.prompts

    # warm-up outside the timed window: first use of every stage, one
    # request per replica (JSQ spreads them one per idle replica)
    wrng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0]))
    for _ in range(len(getattr(engine, "replicas", ())) or 1):
        engine.submit(wrng.integers(0, vocab_size, int(lens[0])), 2)
    t0 = time.perf_counter()
    engine.run()
    compile_s = time.perf_counter() - t0
    engine.reset()           # also empties the prefix index: the timed
    #                          run starts from a cold cache

    ids = [engine.submit(prompts[i], new_tokens,
                         arrival=float(arrivals[i]),
                         priority=int(prios[i]))
           for i in range(requests)]
    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0

    toks = sum(len(done[i].tokens) for i in ids)
    lat = np.asarray([done[i].t_done - done[i].arrival for i in ids])
    ttft = np.asarray([done[i].t_first - done[i].arrival for i in ids])
    cache_rows = np.asarray([done[i].cache_rows for i in ids])
    gaps = [np.diff(done[i].t_tokens) for i in ids
            if len(done[i].t_tokens) >= 2]
    itl = np.concatenate(gaps) if gaps else np.zeros(1)
    stats = engine.stats
    out = {
        "requests": requests,
        "slots": engine.scfg.batch,
        "prompt_budget": prompt_budget,
        "new_tokens": new_tokens,
        "arrival_mode": arrival_mode,
        "tokens": toks,
        "wall_s": round(wall, 3),
        "tok_per_s": round(toks / wall, 1),
        "req_p50_ms": _ms(_pct(lat, 50)),
        "req_p99_ms": _ms(_pct(lat, 99)),
        "ttft_p50_ms": _ms(_pct(ttft, 50)),
        "ttft_p99_ms": _ms(_pct(ttft, 99)),
        "itl_p50_ms": _ms(_pct(itl, 50), 2),
        "itl_p99_ms": _ms(_pct(itl, 99), 2),
        "cache_kb_per_req": round(float(cache_rows.mean())
                                  * engine.cache_token_bytes / 1024.0, 1),
        "preemptions": stats["preemptions"],
        "occupancy": round(stats["occupancy"], 3),
        "concurrency": round(stats["concurrency"], 2),
        "pool_pages": stats["pool_pages"],
        "prefix_hit_rate": round(stats["prefix_hit_rate"], 3),
        "prefill_tokens": stats["prefill_tokens"],
        "spec": bool(engine.scfg.spec_decode),
        "acceptance_rate": round(stats["acceptance_rate"], 3),
        "tokens_per_step": round(stats["tokens_per_step"], 3),
        "spec_rollback_pages": stats["spec_rollback_pages"],
        "prefill_waves": stats["prefill_waves"],
        "decode_chunks": stats["decode_chunks"],
        "swap_out": stats["swap_out"],
        "swap_in": stats["swap_in"],
        "replay_steps_saved": stats["replay_steps_saved"],
        "prefix_cold_hits": stats["prefix_cold_hits"],
        "truncated": int(sum(done[i].truncated for i in ids)),
        "compile_s": round(compile_s, 2),
        "compile_counts": engine.compile_counts,
        "device_count": int(getattr(engine, "device_count", 1)),
        "mesh_shape": list(getattr(engine, "mesh_shape", (1, 1))),
        "dp_replicas": stats.get("dp_replicas", 1),
        "workload_shape": {
            "seed": seed,
            "stagger_s": stagger_s,
            "priority_mix": priority_mix,
            "shared_prefix": shared_prefix,
            **draw.summary(new_tokens),
        },
    }
    if priority_mix > 0.0:
        # both class keys whenever a split was asked for (None if empty)
        for cls, name in ((1, "hi"), (0, "lo")):
            out[f"{name}_req_p50_ms"] = _ms(_pct(lat[prios == cls], 50))
    if "per_replica" in stats:
        out["per_replica"] = stats["per_replica"]
    if collect_streams:
        out["streams"] = {n: list(done[i].tokens)
                          for n, i in enumerate(ids)}
    return out
