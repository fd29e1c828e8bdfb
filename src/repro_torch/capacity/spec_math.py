"""Geometric-run speculative-decoding estimator (port of
``repro.capacity.spec_math``, a copy: plain Python).

Self-speculative decoding (``ServeConfig.spec_decode``) drafts
``spec_k`` tokens with the quantized program and verifies them in one
dense multi-token forward.  Its payoff is governed by a single scalar,
the per-draft acceptance rate ``alpha``, through the geometric-run
model: a round emits the accepted draft prefix plus one more token (the
correction on the first rejection, or the bonus token when everything
survives), so

    E[tokens/round](alpha, k) = 1 + alpha + ... + alpha^k
                              = (1 - alpha^(k+1)) / (1 - alpha)

and the per-token speedup over an autoregressive dense engine (one
dense forward per token) is

    speedup = E[tokens/round] / (k * c_draft + c_verify)

where ``c_draft`` is a draft forward's cost relative to a dense decode
forward and ``c_verify`` the (k+1)-token verify forward's.
``repro_torch.capacity.model`` uses E[tokens/round] as each spec slot's
per-round emission rate.
"""

from __future__ import annotations

__all__ = ["expected_tokens_per_round", "speedup",
           "acceptance_from_tokens_per_step"]


def expected_tokens_per_round(alpha: float, k: int) -> float:
    """E[tokens emitted per draft+verify round] for per-draft
    acceptance ``alpha`` and draft length ``k`` (geometric-run model:
    accepted prefix + correction/bonus)."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if alpha == 1.0:
        return float(k + 1)
    return (1.0 - alpha ** (k + 1)) / (1.0 - alpha)


def speedup(alpha: float, k: int, c_draft: float = 0.5,
            c_verify: float = 1.0) -> float:
    """Per-token speedup over the autoregressive dense engine.  Costs
    are relative to one dense single-token decode forward; c_draft is
    the *quantized* draft forward (< 1 when the nibble path is cheaper,
    which is the paper's premise), c_verify the one (k+1)-token dense
    forward (≈ 1 while decode stays memory-bound: the weights are read
    once either way)."""
    if c_draft <= 0 or c_verify <= 0:
        raise ValueError("relative costs must be positive")
    return expected_tokens_per_round(alpha, k) / (k * c_draft + c_verify)


def acceptance_from_tokens_per_step(tps: float, k: int,
                                    tol: float = 1e-9) -> float:
    """Invert E[tokens/round] for ``alpha`` by bisection (the map is
    strictly increasing on [0, 1]).  ``tps`` must lie in
    [1, k + 1]; the endpoints invert exactly."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 1.0 <= tps <= k + 1:
        raise ValueError(f"tokens_per_step {tps} outside [1, {k + 1}] "
                         f"for k={k}")
    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if expected_tokens_per_round(mid, k) < tps:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
