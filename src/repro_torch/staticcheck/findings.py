"""Finding records and the suppression baseline (port of
``repro.staticcheck.findings``, copied).

A finding's ``key`` deliberately excludes line numbers and message
text: it is ``rule:path:where``, where ``where`` is a qualified name
(AST layer) or ``cell/stage`` context (graph layer).  Keys therefore
survive unrelated edits to the same file, and a suppression only goes
stale when the flagged construct itself disappears — which the gate
detects and fails on (stale suppressions hide regressions).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str      # e.g. "SC101"
    path: str      # repo-relative posix path, or "graph:<cell>" context
    where: str     # qualname (AST) or stage/detail (graph)
    message: str   # human-readable; NOT part of the key
    line: int = 0  # source line (AST layer only); NOT part of the key

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.where}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule} {loc} [{self.where}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_baseline(path: str | Path) -> dict:
    """Read a suppression baseline.  Shape::

        {"version": 1,
         "suppressions": [{"key": "SC101:src/...:fn", "reason": "..."}]}

    A missing file is an empty baseline (the gate still runs)."""
    p = Path(path)
    if not p.exists():
        return {"version": 1, "suppressions": []}
    data = json.loads(p.read_text())
    if not isinstance(data.get("suppressions"), list):
        raise ValueError(f"malformed baseline {p}: expected a "
                         f"'suppressions' list")
    return data


def apply_baseline(findings: list[Finding], baseline: dict):
    """Split findings by the baseline.

    Returns ``(unsuppressed, suppressed, stale_keys)`` where
    ``stale_keys`` are baseline entries that matched nothing — each of
    those is itself a gate failure, so fixed findings must be removed
    from the baseline in the same change."""
    keys = {e["key"] for e in baseline.get("suppressions", [])}
    unsuppressed = [f for f in findings if f.key not in keys]
    suppressed = [f for f in findings if f.key in keys]
    fired = {f.key for f in findings}
    stale = sorted(keys - fired)
    return unsuppressed, suppressed, stale
