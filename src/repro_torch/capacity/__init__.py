"""Analytic serving-capacity model (port of ``repro.capacity``): predict
tok/s, TTFT, cache footprint, concurrency and preemption risk from (knobs,
workload shape, per-stage costs) without running the model, and hold the
predictions to measured rows.

- ``spec_math``: the geometric-run speculative-decoding estimator.
- ``model``: :class:`Knobs` / :class:`WorkloadShape` /
  :class:`StageCosts` and :func:`predict`, the discrete-event replay of
  the engine's scheduler.
- ``calibrate``: measured per-dispatch stage costs of a live engine.
- ``tune``: the knob grid and search behind ``--autotune``.
- ``validate``: model-vs-measured checks over bench rows.
"""

from repro_torch.capacity.model import (CapacityError, Knobs, StageCosts,
                                        WorkloadShape,
                                        analytic_cache_token_bytes, predict)
from repro_torch.capacity.spec_math import (acceptance_from_tokens_per_step,
                                            expected_tokens_per_round,
                                            speedup)

__all__ = ["CapacityError", "Knobs", "StageCosts", "WorkloadShape",
           "analytic_cache_token_bytes", "predict",
           "acceptance_from_tokens_per_step",
           "expected_tokens_per_round", "speedup"]
