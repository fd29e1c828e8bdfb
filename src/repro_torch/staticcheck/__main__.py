"""Static-analysis gate CLI (the counterpart of the reference's
``tools/staticcheck.py``).

Usage:
    python -m repro_torch.staticcheck               # AST + grid on the card
    python -m repro_torch.staticcheck --device cpu  # AST + plain-route grid
    python -m repro_torch.staticcheck --ast-only    # lint, no engines
    python -m repro_torch.staticcheck --device cpu --report out.json
    python -m repro_torch.staticcheck --update-baseline

Exit status: 0 = clean (every finding suppressed, no stale
suppressions); 1 = unsuppressed findings or stale baseline entries.
The grid runs on the card unless ``--device cpu`` asks for the CPU, and
raises when there is no card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
SRC = PACKAGE.parent.parent
REPO_ROOT = SRC.parent
DEFAULT_BASELINE = PACKAGE / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(SRC / "repro_torch"),
                    help="tree to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="suppression baseline JSON")
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the engine grid (no engine builds)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the grid runs: every cell (nibble-cuda "
                         "included) on the card, the default; the "
                         "plain-route cells on the CPU")
    ap.add_argument("--report", metavar="PATH",
                    help="write a JSON summary (rules run, findings, "
                         "per-stage flop/byte table)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to suppress every "
                         "current finding (check the diff!)")
    args = ap.parse_args(argv)

    from repro_torch.staticcheck import run_gate
    from repro_torch.staticcheck.findings import (apply_baseline,
                                                  load_baseline)

    findings, report = run_gate(args.root, REPO_ROOT,
                                ast_only=args.ast_only, device=args.device)

    if args.update_baseline:
        data = {"version": 1, "suppressions": [
            {"key": f.key, "reason": "TODO: justify or fix"}
            for f in sorted(findings, key=lambda f: f.key)]}
        Path(args.baseline).write_text(json.dumps(data, indent=2) + "\n")
        print(f"baseline rewritten with {len(findings)} suppressions: "
              f"{args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    unsuppressed, suppressed, stale = apply_baseline(findings, baseline)
    report["suppressed"] = [f.to_dict() for f in suppressed]
    report["stale_suppressions"] = stale
    report["findings"] = [f.to_dict() for f in unsuppressed]

    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2,
                                                default=str) + "\n")

    for f in unsuppressed:
        print(f.render())
    for key in stale:
        print(f"STALE suppression (no longer fires — remove it): {key}")

    n_cost = len(report.get("stage_costs", []))
    status = "FAIL" if (unsuppressed or stale) else "OK"
    print(f"staticcheck {status}: {len(unsuppressed)} finding(s), "
          f"{len(suppressed)} suppressed, {len(stale)} stale "
          f"suppression(s), {n_cost} stage walk(s) analysed on "
          f"{args.device}")
    return 1 if (unsuppressed or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
