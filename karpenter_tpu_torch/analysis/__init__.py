"""graftlint for the port: the copy of ``karpenter_tpu/analysis`` that
checks ``karpenter_tpu_torch``.

Rule families over the package AST (stdlib-only, importing neither torch
nor the package it inspects — cheap enough to run as a tier-1 gate):

- GL1xx device-queue safety (tracing.py): host reads of a tensor, and
  compile wrappers built in loops, in code reachable from the functions
  that queue work on the card (the entry table ``DEVICE_ENTRIES``, which
  takes the place of ``jax.jit`` / ``pl.pallas_call``). GL102 and GL103
  are reserved (tracing.py says why).
- GL4xx observability safety (tracing.py, riding the same GL1xx
  reachability pass): no obs flight-recorder span enter/exit
  (``span``/``round_trace``), anomaly/recorder mutation, device-plane,
  decision, capsule or timeline hook may be reachable from those entries
  — the planes stay off the pack loop by construction.
- GL2xx lock discipline (locks.py): unguarded mutation of lock-guarded
  state, ABBA lock-order cycles, and plain-Lock re-entry deadlocks.
- GL3xx drift (drift.py): stale/dead ``__init__`` export surface and
  swallowed exceptions in controller reconcile paths.
- GL5xx contracts (contracts.py): env-knob discipline + cache-fingerprint
  coverage (GL501), closed decision-ledger enums checked against
  obs/decisions.py SITES with wrapper/carrier resolution (GL502),
  capsule-seam coverage on every shared-dispatch path (GL503), and
  host-sync-inside-dispatch-loop detection (GL504).

CLI: ``python -m karpenter_tpu_torch.analysis [paths...]`` (default
``karpenter_tpu_torch``) with ``--rules``,
``--json``, ``--baseline FILE`` / ``--update-baseline``. Exit codes:

- **0** — no unsuppressed, non-baselined findings (also ``--rules`` and a
  successful ``--update-baseline``).
- **1** — at least one unsuppressed finding survived baseline filtering.
- **2** — usage or I/O error (unknown rule id in ``--rules``, unreadable
  path, unwritable baseline).

The baseline is a findings snapshot (one rendered ``path:line: RULE msg``
per line; ``#`` comments and blanks ignored) that lets a new rule land
strict-on-new-code while the tree burns down; the port commits no
baseline — its tree is clean (``tests/test_torch_analysis.py``) and must
stay so.
Suppress a justified pattern inline::

    # graftlint: disable=GL101 -- host-side guard; jitted callers pass it

See core.py for the directive grammar (line, def/class scope, and
file-level forms).
"""

from __future__ import annotations

from karpenter_tpu_torch.analysis.contracts import (
    RULES as _CONTRACT_RULES,
    check_contracts,
    producer_census,
)
from karpenter_tpu_torch.analysis.core import Finding, Project
from karpenter_tpu_torch.analysis.drift import RULES as _DRIFT_RULES, check_drift
from karpenter_tpu_torch.analysis.locks import RULES as _LOCK_RULES, check_locks
from karpenter_tpu_torch.analysis.tracing import RULES as _TRACING_RULES, check_tracing

RULES: dict = {**_TRACING_RULES, **_LOCK_RULES, **_DRIFT_RULES,
               **_CONTRACT_RULES}

__all__ = [
    "Finding",
    "Project",
    "RULES",
    "analyze_project",
    "analyze_paths",
    "analyze_sources",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
    "preflight",
    "preflight_report",
    "producer_census",
]


def analyze_project(project: Project, rules=None):
    """Run every rule family; returns (findings, suppressed) sorted by
    position, deduplicated by (path, line, rule). ``rules`` (an iterable
    of ids) restricts the output — the passes still run whole-program so
    inter-procedural context is never truncated."""
    raw = (check_tracing(project) + check_locks(project)
           + check_drift(project) + check_contracts(project))
    by_path = {m.path: m for m in project.modules.values()}
    keep = set(rules) if rules is not None else None
    findings, suppressed, seen = [], [], set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.path, f.line, f.rule)
        if key in seen:
            continue
        seen.add(key)
        if keep is not None and f.rule not in keep:
            continue
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            suppressed.append(f)
        else:
            findings.append(f)
    return findings, suppressed


def analyze_paths(paths, rules=None):
    return analyze_project(Project.from_paths(paths), rules=rules)


def analyze_sources(sources: dict, rules=None):
    """Fixture entry point: {dotted_module_name: source} -> (findings,
    suppressed). Used by tests to seed positive/negative rule fixtures."""
    return analyze_project(Project.from_sources(sources), rules=rules)


def load_baseline(path) -> set:
    """A baseline file -> set of rendered finding lines. A missing file is
    an empty baseline (new checkouts start strict)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except FileNotFoundError:
        return set()
    return {ln.strip() for ln in lines
            if ln.strip() and not ln.strip().startswith("#")}


def write_baseline(path, findings) -> None:
    """Snapshot ``findings`` (Finding objects or rendered strings) so a
    new rule can land strict-on-new-code while the listed debt burns
    down."""
    rendered = sorted(
        f if isinstance(f, str) else f.render() for f in findings
    )
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# graftlint baseline — accepted findings, one rendered\n"
                 "# `path:line: RULE message` per line. Burn down, never\n"
                 "# grow: remove lines as the debt is fixed.\n")
        for line in rendered:
            fh.write(line + "\n")


def apply_baseline(findings, baseline: set):
    """-> (new, baselined): findings whose rendered line is in the
    baseline are accepted debt, everything else must be fixed."""
    new, baselined = [], []
    for f in findings:
        (baselined if f.render() in baseline else new).append(f)
    return new, baselined


def preflight(paths) -> list:
    """Rendered unsuppressed findings for embedding callers (a long run can
    call this first so a lint regression fails in seconds)."""
    findings, _ = analyze_paths(paths)
    return [f.render() for f in findings]


def preflight_report(paths, baseline_path=None) -> dict:
    """Machine-readable full-rule-set report (the ``--json`` payload):
    findings after baseline filtering, suppression/baseline counts, the
    GL502 producer census, and the rule table. ``ok`` is the exit-0
    condition."""
    project = Project.from_paths(paths)
    findings, suppressed = analyze_project(project)
    baseline = load_baseline(baseline_path) if baseline_path else set()
    new, baselined = apply_baseline(findings, baseline)
    return {
        "ok": not new,
        "findings": [f.render() for f in new],
        "baselined": [f.render() for f in baselined],
        "suppressed": len(suppressed),
        "census": producer_census(project),
        "rules": dict(sorted(RULES.items())),
    }
