"""``python -m karpenter_tpu_torch.analysis [paths...]`` — the graftlint CLI.

Prints one ``path:line: RULE-ID message`` per unsuppressed finding and
exits per the contract documented in ``analysis/__init__.py``: 0 clean,
1 when findings survive baseline filtering, 2 on usage/I/O errors.
Multiple roots are supported (``karpenter_tpu_torch/ chip_smoke.py``);
``--rules`` restricts reporting to a comma-separated id set, ``--json``
emits the machine-readable preflight report, ``--baseline FILE``
subtracts a committed findings snapshot (``--update-baseline`` rewrites
it). Suppressed counts ride the summary line so justified exceptions
stay visible. This is the port's tier-1 gate entry point
(tests/test_torch_analysis.py asserts a zero-finding tree).
"""

from __future__ import annotations

import argparse
import json
import sys

from karpenter_tpu_torch.analysis import (
    RULES,
    analyze_project,
    apply_baseline,
    load_baseline,
    producer_census,
    write_baseline,
)
from karpenter_tpu_torch.analysis.core import Project


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="karpenter_tpu_torch.analysis",
        description="graftlint: tracing-safety, lock-discipline, drift, "
        "and contract checks for the karpenter_tpu_torch tree",
    )
    ap.add_argument("paths", nargs="*", default=["karpenter_tpu_torch"],
                    help="files or directories to analyze "
                    "(default: karpenter_tpu_torch)")
    ap.add_argument("--list-rules", "--rules-table", action="store_true",
                    dest="list_rules", help="print the rule ids and exit")
    ap.add_argument("--rules", default=None, metavar="GL101,GL502,...",
                    help="restrict reporting to these comma-separated rule ids")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report (findings, "
                    "baseline split, suppressed count, GL502 census)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="subtract this findings snapshot; missing file = "
                    "empty baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline FILE from the current findings "
                    "and exit 0")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule}  {RULES[rule]}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            print(f"graftlint: unknown rule id(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
    if args.update_baseline and not args.baseline:
        print("graftlint: --update-baseline requires --baseline FILE",
              file=sys.stderr)
        return 2

    try:
        project = Project.from_paths(args.paths or ["karpenter_tpu_torch"])
    except (FileNotFoundError, OSError) as exc:
        print(f"graftlint: {exc}", file=sys.stderr)
        return 2

    findings, suppressed = analyze_project(project, rules=rules)

    if args.update_baseline:
        try:
            write_baseline(args.baseline, findings)
        except OSError as exc:
            print(f"graftlint: cannot write baseline: {exc}",
                  file=sys.stderr)
            return 2
        print(f"graftlint: baseline updated ({len(findings)} finding(s))",
              file=sys.stderr)
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else set()
    new, baselined = apply_baseline(findings, baseline)

    if args.json:
        print(json.dumps({
            "ok": not new,
            "findings": [f.render() for f in new],
            "baselined": [f.render() for f in baselined],
            "suppressed": len(suppressed),
            "census": producer_census(project),
            "rules": {r: RULES[r] for r in sorted(rules or RULES)},
        }, indent=2, sort_keys=True))
        return 1 if new else 0

    for f in new:
        print(f.render())
    print(
        f"graftlint: {len(new)} finding(s), "
        f"{len(baselined)} baselined, {len(suppressed)} suppressed",
        file=sys.stderr,
    )
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
