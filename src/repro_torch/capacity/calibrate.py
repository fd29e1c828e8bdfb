"""Measured stage-cost calibration for the capacity model (port of
``repro.capacity.calibrate``).

:func:`calibrate_engine` turns a live engine into a
:class:`~repro_torch.capacity.model.StageCosts`: each stage the engine's
mode runs (``Engine.stage_programs``) is run again on one recorded
signature (``stage.rerun``: a bare stage on zero tensors of that
signature, a captured stage by replaying its CUDA graph on its static
buffers) and timed, the minimum over a few repeats.  On the card each
timed call is bracketed by ``torch.cuda.synchronize()``; on the CPU it is
wall time.  That isolates the device cost of one dispatch; the host cost
per dispatch (scheduler walk, staging copies, host reads) is solved from a
small zero-arrival probe run:

    overhead_s = max(0, (wall_probe - sum(stage_s * dispatches))
                        / total_dispatches)

The probe is separate from any workload being predicted, so the
constants are never fitted to the row they are checked against.

The port's stages write the engine's caches in place (the reference's
were handed fresh arrays), so a rerun leaves stale rows in the pools:
calibration takes a drained engine and resets it afterwards (which also
empties the prefix index), keeping its request-id counter and its base
sampling key, so the streams it serves next are the ones it would have
served without calibration.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.capacity.model import StageCosts
from repro_torch.models.transformer import extract_cache_pages, \
    insert_cache_pages
from repro_torch.serve.paging import pages_needed

__all__ = ["calibrate_engine", "time_stage"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_stage(stage, *, iters: int = 3) -> float:
    """Seconds per dispatch of one engine stage: the minimum over
    ``iters`` timed reruns of its first recorded signature (one untimed
    rerun first)."""
    sig = stage.signatures[0]
    best = float("inf")
    for i in range(iters + 1):
        _sync(stage.device)
        t0 = time.perf_counter()
        stage.rerun(sig)
        _sync(stage.device)
        if i:
            best = min(best, time.perf_counter() - t0)
    return best


def _time_swap_event(engine, *, iters: int = 3) -> float:
    """Seconds per host-tier swap event: a swap-out extracts, and a
    swap-in inserts, all of an event's pages in one transfer, so the cost
    is flat in page count.  Times a one-page extract and insert round trip
    of page 1 (page 0 is the trash page) through the engine's page helpers
    and halves it."""
    best = float("inf")
    for _ in range(iters):
        _sync(engine.device)
        t0 = time.perf_counter()
        payload = extract_cache_pages(engine._caches, [1],
                                      pad_to=engine._max_pages)
        insert_cache_pages(engine._caches, [1], payload,
                           pad_to=engine._max_pages)
        _sync(engine.device)
        best = min(best, time.perf_counter() - t0)
    return best / 2.0


def _probe_overhead(engine, costs: StageCosts) -> float:
    """Per-scheduler-iteration host overhead solved from a zero-arrival
    probe run at full slot width (the reference's probe and solve).  The
    divisor counts iterations as the simulator charges them: one per
    monolithic prefill, decode chunk, wave, or draft + verify round."""
    scfg = engine.scfg
    p_len = scfg.prefill_len or max(1, scfg.max_len // 4)
    # decode-heavy, shrunk until the pool holds the whole probe (a
    # preempting probe replays tokens and muddies the solve)
    new = max(2, min(32, scfg.max_len - p_len))
    if getattr(engine, "allocator", None) is not None:
        cap = engine.allocator.capacity
        while new > 4 and (scfg.batch
                           * pages_needed(p_len + new - 1,
                                          engine.cfg.page_size)) > cap:
            new //= 2
    requests = scfg.batch

    def _submit_all(rng):
        for _ in range(requests):
            engine.submit(rng.integers(0, 8, p_len, dtype=np.int64), new)

    # an untimed pass first: the probe's mix may meet a stage signature
    # the workload never ran
    engine.reset()
    try:
        _submit_all(np.random.default_rng(0xCA11B))
    except ValueError:
        engine.reset()
        return 0.0
    engine.run()

    engine.reset()
    base = engine.stats
    base_counts = (base["decode_chunks"], base["prefill_waves"],
                   base["spec_rounds"], base["prefill_tokens"])
    _submit_all(np.random.default_rng(0xCA11B))
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    stats = engine.stats
    n_chunks = stats["decode_chunks"] - base_counts[0]
    n_waves = stats["prefill_waves"] - base_counts[1]
    n_spec = stats["spec_rounds"] - base_counts[2]
    # placements, not submissions: a preempted probe request prefills its
    # prompt again on resume
    n_prefill = (0 if n_waves else
                 (stats["prefill_tokens"] - base_counts[3]) // p_len)
    engine.reset()

    modeled = (n_prefill * costs.prefill_s
               + n_chunks * costs.decode_chunk_s
               + n_waves * costs.prefill_chunk_s
               + n_spec * (costs.draft_s + costs.verify_s))
    dispatches = n_prefill + n_chunks + n_waves + n_spec
    if dispatches == 0:
        return 0.0
    return max(0.0, (wall - modeled) / dispatches)


def calibrate_engine(engine, *, iters: int = 3,
                     probe: bool = True) -> StageCosts:
    """Measure per-dispatch stage costs of a drained, warm engine (run it
    at least once, so every stage has a recorded signature; stages the
    mode never built stay at 0.0).  The engine is reset afterwards, with
    its request ids and base key kept."""
    if len(engine._queue) or any(r is not None for r in engine._slots):
        raise ValueError("calibrate_engine needs a drained engine: its "
                         "stage reruns write the caches in place")
    next_id, base_key = engine._next_id, engine._base_key
    costs = StageCosts(source="measured")
    names = {"prefill": "prefill_s",
             "prefill_chunk": "prefill_chunk_s",
             "decode_chunk": "decode_chunk_s",
             "draft": "draft_s",
             "verify": "verify_s"}
    with torch.no_grad():
        for name, stage in engine.stage_programs().items():
            if stage.signatures:
                setattr(costs, names[name], time_stage(stage, iters=iters))
        if engine.host_pool is not None:
            costs.swap_event_s = _time_swap_event(engine, iters=iters)
    if probe:
        costs.overhead_s = _probe_overhead(engine, costs)
    engine.reset()
    engine._next_id, engine._base_key = next_id, base_key
    return costs
