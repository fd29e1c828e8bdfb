"""Model-vs-measured validation over ``BENCH_serve.json`` rows (port of
``repro.capacity.validate``, a copy over the port's ``model``; it reads
the reference's committed rows, whose knobs name the reference's
backends, as plain data).

Every benchmark row carries a ``capacity`` blob — the exact knob set,
workload shape, calibrated per-dispatch stage costs, measured
speculative acceptance and cache bytes/token its prediction was
computed from.  Validation **replays** the prediction from that blob
(it does not trust the stored numbers) and compares against the row's
measured ``tok_per_s`` / ``ttft_p50_ms``, so the committed JSON is a
self-contained regression fixture: any machine can re-run the analytic
model against the measurements without re-benchmarking, and a model
change that breaks agreement fails the tests.

Tolerance policy (the reference's): a metric passes
when ``|predicted - measured| <= max(rel * measured, abs_floor)``.
The relative band absorbs CPU-proxy timer noise and the model's known
simplifications; the absolute floor keeps sub-millisecond TTFT rows
from failing on microsecond jitter.  Only rows the model claims to
cover (``gated: true`` — single-device, no prefix cache) gate; the
rest still carry predictions for trend-watching.
"""

from __future__ import annotations

import json

from repro_torch.capacity.model import (Knobs, StageCosts, WorkloadShape,
                                        predict)

__all__ = ["TOLERANCE", "check_row", "validate_rows", "load_bench"]

# metric -> (relative tolerance, absolute floor in the metric's unit).
# 0.40 relative: the CPU functional proxy's run-to-run wall-clock
# variance on the fast uniform rows is ~25% by itself; the model's
# structural predictions (dispatch counts, preemptions, swap events)
# are exact, so the band is timer noise, not model slack.
TOLERANCE = {
    "tok_per_s": (0.40, 0.0),
    "ttft_p50_ms": (0.40, 5.0),
}


def load_bench(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["results"]


def predict_row(row: dict) -> dict | None:
    """Replay the analytic prediction from a row's embedded capacity
    blob; None when the row carries no blob (mesh/router rows)."""
    blob = row.get("capacity")
    if not blob:
        return None
    return predict(Knobs.from_dict(blob["knobs"]),
                   WorkloadShape.from_dict(blob["shape"]),
                   StageCosts.from_dict(blob["costs"]),
                   cache_token_bytes=blob.get("cache_token_bytes", 0),
                   acceptance=blob.get("acceptance"))


def check_row(row: dict, tolerance: dict | None = None) -> dict | None:
    """One row's model-vs-measured verdict: per-metric predicted /
    measured / err_pct / ok plus the row-level ``ok`` (vacuously true
    for ungated rows).  None when the row has no capacity blob."""
    tol = tolerance or TOLERANCE
    pred = predict_row(row)
    if pred is None:
        return None
    gated = bool(row["capacity"].get("gated"))
    metrics = {}
    ok = pred.get("feasible", False)
    for name, (rel, floor) in tol.items():
        measured = float(row[name])
        predicted = float(pred.get(name, float("nan")))
        err = abs(predicted - measured)
        bound = max(rel * measured, floor)
        m_ok = err <= bound
        metrics[name] = {
            "measured": measured, "predicted": round(predicted, 3),
            "err_pct": round(100.0 * err / max(measured, 1e-9), 1),
            "bound": round(bound, 3), "ok": m_ok,
        }
        ok = ok and m_ok
    return {
        "workload": row.get("workload"), "quant": row.get("quant"),
        "backend": row.get("backend"), "cache": row.get("cache"),
        "alloc": row.get("alloc"), "spec": row.get("spec"),
        "tail": row.get("tail", "-"), "gated": gated,
        "metrics": metrics, "ok": ok or not gated, "within": ok,
    }


def validate_rows(rows: list[dict],
                  tolerance: dict | None = None) -> tuple[bool, list]:
    """Check every row carrying a capacity blob.  Returns
    ``(all_gated_rows_pass, per_row_checks)``; fails (False) if no
    gated row exists at all — an empty gate guards nothing."""
    checks = [c for c in (check_row(r, tolerance) for r in rows)
              if c is not None]
    gated = [c for c in checks if c["gated"]]
    ok = bool(gated) and all(c["within"] for c in gated)
    return ok, checks
