"""Knob-space search over the analytic capacity model (port of
``repro.capacity.tune``, a copy over the port's ``model``).

The grid, the objective-driven search and the report table behind the
serving launcher's ``--autotune`` flag (the port's counterpart of the
reference's ``tools/autotune.py``).  Costs come from
:meth:`StageCosts.from_model` (closed-form MACs and bytes over a device's
peak rates, the H100's by default): ranking knob settings needs relative
fidelity, not wall-clock truth; the calibrated path
(``repro_torch.capacity.calibrate``) owns model-vs-measured checks.
"""

from __future__ import annotations

from repro_torch.capacity.model import (CapacityError, Knobs, StageCosts,
                                        WorkloadShape,
                                        analytic_cache_token_bytes, predict)

__all__ = ["knob_grid", "search", "table_lines"]


def knob_grid(shape: WorkloadShape, *, batch: int, max_len: int,
              prefill_len: int, page_size_opts=(4, 8),
              small: bool = False):
    """The structured knob space: one dense baseline sweep plus paged
    variants crossing allocation mode, pool size, wave prefill, swap
    and speculative decoding.  ``small`` is the CI grid."""
    chunks = (1, 8) if small else (1, 4, 8)
    pools_frac = (0.5, 1.0) if small else (0.25, 0.5, 1.0)
    cells = []
    for dc in chunks:
        cells.append(Knobs(batch=batch, max_len=max_len,
                           prefill_len=prefill_len, decode_chunk=dc,
                           cache_mode="dense"))
    for ps in (page_size_opts[:1] if small else page_size_opts):
        parity = batch * (max_len // ps) + 1
        pools = sorted({max(2, int(parity * f)) | 1 for f in pools_frac})
        for np_ in pools:
            for alloc in ("reserve", "incremental"):
                for dc in chunks:
                    cells.append(Knobs(
                        batch=batch, max_len=max_len,
                        prefill_len=prefill_len, decode_chunk=dc,
                        cache_mode="paged", page_size=ps, num_pages=np_,
                        alloc_mode=alloc))
            # wave prefill + grouped admission (+ host swap)
            for swap in (("off",) if small else ("off", "host")):
                cells.append(Knobs(
                    batch=batch, max_len=max_len,
                    prefill_len=prefill_len, decode_chunk=8,
                    cache_mode="paged", page_size=ps, num_pages=np_,
                    alloc_mode="incremental",
                    prefill_chunk=max(1, prefill_len // 4),
                    admit_group=batch, swap_mode=swap))
            # speculative decoding on the parity pool
            for k in ((4,) if small else (2, 4)):
                cells.append(Knobs(
                    batch=batch, max_len=max_len,
                    prefill_len=prefill_len, decode_chunk=1,
                    cache_mode="paged", page_size=ps, num_pages=parity,
                    alloc_mode="incremental", spec_decode=True,
                    spec_k=k, quant_mode="w8a8_nibble"))
    # Knobs is frozen/hashable: drop duplicate cells, keep first-seen
    return list(dict.fromkeys(cells))


def search(cfg, shape: WorkloadShape, cells, *, objective: str,
           ttft_slo_ms: float | None, alpha: float,
           dispatch_s: float = 5e-5):
    """Predict every cell and rank the feasible ones.  Returns
    (results, winner) where each result is ``{knobs, prediction,
    admissible, reason}``."""
    ctb = analytic_cache_token_bytes(cfg)
    results = []
    for knobs in cells:
        try:
            costs = StageCosts.from_model(
                cfg, knobs, prompt_budget=shape.prompt_budget,
                dispatch_s=dispatch_s)
            pred = predict(knobs, shape, costs, cache_token_bytes=ctb,
                           acceptance=alpha if knobs.spec_decode
                           else None)
        except CapacityError as e:
            results.append({"knobs": knobs, "prediction": None,
                            "admissible": False, "reason": str(e)})
            continue
        admissible = bool(pred["feasible"])
        if admissible and ttft_slo_ms is not None:
            admissible = pred["ttft_p99_ms"] <= ttft_slo_ms
        if admissible and objective == "min-pages":
            admissible = (knobs.paged and pred["preemptions"] == 0)
        results.append({"knobs": knobs, "prediction": pred,
                        "admissible": admissible,
                        "reason": pred.get("infeasible_reason")})
    ranked = [r for r in results if r["admissible"]]
    if objective == "min-pages":
        ranked.sort(key=lambda r: (r["knobs"].resolved_num_pages,
                                   -r["prediction"]["tok_per_s"]))
    else:
        ranked.sort(key=lambda r: -r["prediction"]["tok_per_s"])
    winner = ranked[0] if ranked else None
    return results, winner


def table_lines(results, winner):
    yield ("cache,alloc,page_size,pool_pages,decode_chunk,wave,swap,"
           "spec,tok_per_s,ttft_p50_ms,ttft_p99_ms,preempt,"
           "cache_kb_per_req,admissible")
    for r in sorted(results,
                    key=lambda r: -(r["prediction"]["tok_per_s"]
                                    if r["prediction"]
                                    and "tok_per_s" in r["prediction"]
                                    else -1.0)):
        k, p = r["knobs"], r["prediction"]
        mark = " <== winner" if winner is not None \
            and k == winner["knobs"] else ""
        if p is None or "tok_per_s" not in p:
            yield (f"{k.cache_mode},{k.alloc_mode},{k.page_size},"
                   f"{k.resolved_num_pages},{k.decode_chunk},"
                   f"{'on' if k.wave else '-'},{k.swap_mode},"
                   f"{k.spec_k if k.spec_decode else '-'},"
                   f"-,-,-,-,-,no ({r.get('reason')})")
            continue
        yield (f"{k.cache_mode},{k.alloc_mode},{k.page_size},"
               f"{k.resolved_num_pages},{k.decode_chunk},"
               f"{'on' if k.wave else '-'},{k.swap_mode},"
               f"{k.spec_k if k.spec_decode else '-'},"
               f"{p['tok_per_s']:.0f},{p['ttft_p50_ms']:.1f},"
               f"{p['ttft_p99_ms']:.1f},{p['preemptions']},"
               f"{p['cache_kb_per_req']:.1f},"
               f"{'yes' if r['admissible'] else 'no'}{mark}")
