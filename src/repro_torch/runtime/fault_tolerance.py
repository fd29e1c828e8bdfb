"""Fault tolerance hooks (port of the host-side logic of
``repro.runtime.fault_tolerance``): heartbeats and straggler detection,
driven by the trainer loop (and by tests with simulated clocks).

* ``HeartbeatMonitor``  - per-host step heartbeats; a host silent for
  ``timeout_s`` is declared dead (restart-from-checkpoint decision).
* ``StragglerDetector`` - EWMA of per-host step times; hosts slower than
  ``threshold x`` the fleet median for ``patience`` checks are flagged,
  and grad-accumulation microbatches can be rebalanced away from them.

The elastic re-mesh plan (``ElasticPlan``) is not ported yet.
"""

from __future__ import annotations

import math

__all__ = ["HeartbeatMonitor", "StragglerDetector"]


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.last_beat: dict[int, float] = {}

    def beat(self, host_id: int, now: float):
        self.last_beat[host_id] = now

    def dead_hosts(self, now: float) -> list[int]:
        return [h for h in range(self.n_hosts)
                if now - self.last_beat.get(h, -math.inf) > self.timeout_s]

    def healthy(self, now: float) -> bool:
        return not self.dead_hosts(now)


class StragglerDetector:
    """EWMA step-time tracking with median-relative flagging."""

    def __init__(self, n_hosts: int, threshold: float = 1.5,
                 alpha: float = 0.2, patience: int = 3):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.alpha = alpha
        self.patience = patience
        self.ewma: dict[int, float] = {}
        self.strikes: dict[int, int] = {}

    def record(self, host_id: int, step_time_s: float):
        prev = self.ewma.get(host_id)
        self.ewma[host_id] = (step_time_s if prev is None
                              else self.alpha * step_time_s
                              + (1 - self.alpha) * prev)

    def _median(self) -> float:
        vals = sorted(self.ewma.values())
        return vals[len(vals) // 2] if vals else 0.0

    def stragglers(self) -> list[int]:
        med = self._median()
        if med <= 0:
            return []
        out = []
        for h, t in self.ewma.items():
            if t > self.threshold * med:
                self.strikes[h] = self.strikes.get(h, 0) + 1
                if self.strikes[h] >= self.patience:
                    out.append(h)
            else:
                self.strikes[h] = 0
        return out

    def rebalance_microbatches(self, total_micro: int) -> dict[int, int]:
        """Assign grad-accum microbatches inversely to EWMA step time."""
        if not self.ewma:
            return {}
        inv = {h: 1.0 / max(t, 1e-9) for h, t in self.ewma.items()}
        z = sum(inv.values())
        raw = {h: total_micro * v / z for h, v in inv.items()}
        out = {h: max(1, int(round(r))) for h, r in raw.items()}
        # fix rounding drift deterministically (fastest hosts absorb it)
        drift = total_micro - sum(out.values())
        for h in sorted(out, key=lambda h: -inv[h]):
            if drift == 0:
                break
            out[h] += 1 if drift > 0 else -1
            drift += -1 if drift > 0 else 1
        return out
