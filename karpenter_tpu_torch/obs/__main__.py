"""``python -m karpenter_tpu_torch.obs report|replay`` — the obs-plane CLI.

The port's copy of ``karpenter_tpu/obs/__main__.py`` (imports changed).
``report`` renders the ``/introspect`` JSON (decision-ledger rung mixes,
last-K round rung summaries, the solve-quality series, per-tenant rung
mixes, retained anomalous rounds; ``--timeline`` appends the fleet
ledger) from a running metrics server (``--url``), a saved snapshot
(``--file``), or THIS process's ledger.

``replay`` re-executes a captured hot-path dispatch (obs/capsule.py) —
a capsule the port or the JAX package wrote — and grades it against the
capsule's recorded outputs; ``--ab`` additionally races the same capsule
across every eligible rung (device / native / host-FFD; the mesh rungs
report ineligible) and prints a parity + nodes + wall-clock + decision
table. The device rung runs on the card unless ``--device cpu``. Exit
codes, the JAX package's: 0 parity exact, 1 parity mismatch or replay
failure.

    python -m karpenter_tpu_torch.obs report --url http://127.0.0.1:8080
    python -m karpenter_tpu_torch.obs report --file introspect.json --timeline
    python -m karpenter_tpu_torch.obs replay x.capsule.npz --ab --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["render_report", "render_timeline", "render_ab", "run_replay",
           "main"]


def _fmt_mix(rungs: dict) -> str:
    parts = []
    for rung, reasons in sorted(rungs.items()):
        if isinstance(reasons, dict):
            n = sum(reasons.values())
            why = ",".join(
                f"{r}:{c}" for r, c in sorted(reasons.items()) if r != "ok"
            )
            parts.append(f"{rung}={n}" + (f" ({why})" if why else ""))
        else:
            parts.append(f"{rung}={reasons}")
    return "  ".join(parts)


def render_timeline(section: dict) -> str:
    """The fleet-ledger ``timeline`` section of the introspect JSON
    (obs/timeline.py) as a human-readable report (pure — the CLI smoke
    test feeds it a canned section)."""
    lines = ["fleet ledger"]
    lines.append("=" * 64)
    ring = section.get("ring") or {}
    kinds = ring.get("kinds") or {}
    mix = "  ".join(f"{k}={n}" for k, n in sorted(kinds.items()))
    lines.append(
        f"  ring {ring.get('size', 0)}/{ring.get('capacity', 0)} "
        f"(dropped={ring.get('dropped', 0)})" + (f"  {mix}" if mix else ""))
    for ev in section.get("events") or []:
        cause = ev.get("cause") or {}
        why = ""
        if cause:
            why = (f"  <- {cause.get('site', '-')}/{cause.get('rung', '-')}"
                   f"/{cause.get('reason', '-')}")
            if cause.get("command"):
                why += f" [{cause['command']}]"
        tid = f" [{ev['trace_id']}]" if ev.get("trace_id") else ""
        lines.append(f"  {ev.get('kind', '?'):9s} {ev.get('node')}{tid}{why}")
    cost = section.get("cost") or {}
    lines.append("")
    lines.append(
        f"realized cost: total={cost.get('realized_total', 0.0)} "
        f"live_rate={cost.get('live_rate', 0.0)} "
        f"({cost.get('live_nodes', 0)} nodes)")
    for key, amt in sorted((cost.get("realized") or {}).items()):
        lines.append(f"  {key:32s} {amt}")
    commands = section.get("commands") or {}
    reconciled = commands.get("reconciled") or []
    if reconciled or commands.get("pending"):
        lines.append("")
        lines.append(
            f"commands: pending={commands.get('pending', 0)} "
            f"reconciled={len(reconciled)}")
        for c in reconciled:
            verdict = ("within" if c.get("ok")
                       else "DRIFT" if c.get("ok") is False else "unpriced")
            lines.append(
                f"  {c.get('command')} {c.get('site') or '-'}"
                f"/{c.get('rung') or '-'}  predicted={c.get('predicted')} "
                f"realized={c.get('realized')}  {verdict}")
    interruptions = section.get("interruptions") or {}
    if interruptions:
        lines.append("")
        lines.append("observed interruption rates")
        for key, row in sorted(interruptions.items()):
            lines.append(
                f"  {key:24s} notices={row.get('notices', 0)} "
                f"reclaims={row.get('reclaims', 0)} "
                f"exposure_h={row.get('exposure_hours', 0.0)} "
                f"reclaims/h={row.get('reclaims_per_hour', 0.0)}")
    billing = section.get("billing") or {}
    tenants = billing.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append(
            f"tenant billing (total={billing.get('total_device_seconds')}s "
            f"devplane={billing.get('devplane_dispatch_seconds')}s "
            f"dropped={billing.get('dropped_device_seconds')}s)")
        for t, row in sorted(tenants.items()):
            lines.append(
                f"  {t:16s} {row.get('device_seconds', 0.0)}s over "
                f"{row.get('dispatches', 0)} dispatches")
    return "\n".join(lines)


def render_report(snapshot: dict, timeline: bool = False) -> str:
    """The introspect JSON as a human-readable report (pure — the CLI
    smoke test feeds it a canned snapshot). ``timeline`` appends the
    fleet-ledger section (``report --timeline``)."""
    lines = ["decision plane"]
    lines.append("=" * 64)
    sites = snapshot.get("sites") or {}
    if not sites:
        lines.append("  (no decisions recorded)")
    for site, srow in sorted(sites.items()):
        last = srow.get("last") or {}
        held = srow.get("held") or {}
        head = f"  {site:18s} last={last.get('rung', '-')}"
        if last.get("reason") and last.get("reason") != "ok":
            head += f"/{last['reason']}"
        if held:
            head += f"  held={held.get('rung')}x{held.get('streak')}"
        lines.append(head)
        lines.append(f"    {_fmt_mix(srow.get('rungs') or {})}")
    quality = snapshot.get("quality") or {}
    series = quality.get("series") or []
    if series:
        lines.append("")
        lines.append("solve quality (nodes / pods-cap floor)")
        for fam, st in sorted((quality.get("families") or {}).items()):
            flag = "  DRIFTING" if st.get("violating") else ""
            lines.append(
                f"  {fam:12s} baseline={st.get('baseline')} "
                f"streak={st.get('streak')}{flag}")
        tail = series[-5:]
        lines.append("  recent: " + "  ".join(
            f"{s.get('nodes')}/{s.get('floor')}={s.get('ratio')}"
            for s in tail))
    rounds = snapshot.get("rounds") or []
    if rounds:
        lines.append("")
        lines.append(f"last {len(rounds)} rounds")
        for r in rounds:
            mix = "; ".join(
                f"{site}:" + ",".join(
                    f"{rung}x{sum(reasons.values())}"
                    for rung, reasons in sorted(srow.items()))
                for site, srow in sorted((r.get("decisions") or {}).items())
            )
            lines.append(f"  {r.get('round')} [{r.get('trace_id')}]  {mix}")
    tenants = snapshot.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append("per-tenant rung mix")
        for tenant, mix in sorted(tenants.items()):
            row = "; ".join(
                f"{site}:" + _fmt_mix(rungs)
                for site, rungs in sorted(mix.items()))
            lines.append(f"  {tenant:16s} {row}")
    anomalies = snapshot.get("anomalies") or []
    if anomalies:
        lines.append("")
        lines.append("active anomalies (flight-recorder ring)")
        for a in anomalies:
            lines.append(
                f"  {a.get('round')} [{a.get('trace_id')}]  "
                f"{','.join(a.get('kinds') or [])}  "
                f"dump={a.get('dump') or '-'}"
                + (f"  capsule={a['capsule']}" if a.get("capsule") else ""))
    capsules = snapshot.get("capsules") or []
    if capsules:
        lines.append("")
        lines.append("replay capsules (python -m karpenter_tpu_torch.obs "
                     "replay)")
        for c in capsules:
            tenant = f" tenant={c['tenant']}" if c.get("tenant") else ""
            lines.append(
                f"  {c.get('round') or '-'} [{c.get('trace_id') or '-'}]  "
                f"seam={c.get('seam')} engine={c.get('engine')}{tenant}  "
                f"{c.get('why')}  {c.get('path')}")
    if timeline:
        lines.append("")
        lines.append(render_timeline(snapshot.get("timeline") or {}))
    return "\n".join(lines)


def render_ab(rows: list) -> str:
    """The ``replay --ab`` table: one line per rung — parity vs the
    captured outputs, nodes, wall clock, and whether the rung matches the
    one the capture actually ran (the decision diff)."""
    lines = [f"{'rung':12s} {'parity':8s} {'nodes':>7s} {'ms':>10s}  decision"]
    for r in rows:
        if not r.get("eligible", True):
            lines.append(f"{r['rung']:12s} {'-':8s} {'-':>7s} {'-':>10s}  "
                         f"ineligible: {r.get('why')}")
            continue
        decision = ("= captured rung" if r.get("rung_match")
                    else f"captured rung was {r.get('captured_rung')}")
        nodes = r.get("nodes")
        lines.append(
            f"{r['rung']:12s} {r.get('parity', '?'):8s} "
            f"{nodes if nodes is not None else '-':>7} "
            f"{r.get('ms', 0.0):>10.2f}  {decision}")
    return "\n".join(lines)


def run_replay(path: str, ab: bool = False, rung: str | None = None,
               as_json: bool = False, device=None) -> int:
    """The ``replay`` subcommand body (prints and returns the exit code,
    so tests drive it in-process). ``device`` is the device rung's (the
    card when None)."""
    from karpenter_tpu_torch.obs import capsule as _capsule

    try:
        cap = _capsule.load(path)
    except (OSError, ValueError) as e:
        print(f"replay: {e}", file=sys.stderr)
        return 1
    out: dict = {
        "capsule": path,
        "seam": cap.seam,
        "engine": cap.engine,
        "round": cap.meta.get("round"),
        "trace_id": cap.meta.get("trace_id"),
        "anomalies": cap.meta.get("anomalies") or [],
        "decisions": cap.meta.get("decisions") or [],
    }
    try:
        out["replay"] = _capsule.replay(cap, rung=rung, device=device)
    except Exception as e:
        print(f"replay: {type(e).__name__}: {e}", file=sys.stderr)
        out["replay"] = {"error": f"{type(e).__name__}: {e}"}
        if as_json:
            print(json.dumps(out))
        return 1
    if ab:
        out["ab"] = _capsule.ab_compare(cap, device=device)
    if as_json:
        print(json.dumps(out))
    else:
        r = out["replay"]
        print(f"capsule {path}")
        print(f"  seam={cap.seam} engine={cap.engine} "
              f"round={cap.meta.get('round')} "
              f"anomalies={','.join(out['anomalies']) or '-'}")
        print(f"  replay rung={r['rung']} parity={r['parity']} "
              f"nodes={r['nodes']} (captured {r['captured_nodes']}) "
              f"ms={r['ms']}")
        if ab:
            print()
            print(render_ab(out["ab"]))
    return 0 if out["replay"].get("parity") == "exact" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="karpenter_tpu_torch.obs")
    sub = ap.add_subparsers(dest="cmd")
    rep = sub.add_parser(
        "report", help="render the /introspect decision-plane snapshot")
    rep.add_argument("--url", default=None,
                     help="metrics-server base URL (fetches <url>/introspect)")
    rep.add_argument("--file", default=None,
                     help="read a saved introspect JSON instead of fetching")
    rep.add_argument("--json", action="store_true",
                     help="emit the raw JSON instead of the rendered report")
    rep.add_argument("-k", type=int, default=16,
                     help="rounds/anomalies to include (in-process source)")
    rep.add_argument("--timeline", action="store_true",
                     help="append the fleet-ledger section (lifecycle "
                          "events with cause chains, realized cost, "
                          "command reconciliation, interruption rates, "
                          "tenant billing — obs/timeline.py)")
    rpl = sub.add_parser(
        "replay", help="re-execute a replay capsule offline (bit-parity "
                       "graded against its captured outputs)")
    rpl.add_argument("capsule", help="path to a .capsule.npz file")
    rpl.add_argument("--ab", action="store_true",
                     help="also run the capsule across every eligible rung "
                          "and print the parity/nodes/wall-clock table")
    rpl.add_argument("--rung", default=None,
                     help="override the replay rung (device/native/host; "
                          "xla means device; probe capsules: device/"
                          "native; relax capsules: relax/ladder/host)")
    rpl.add_argument("--device", default=None,
                     help="the device rung's device: the card (cuda) by "
                          "default, raising without one; cpu for the plain "
                          "path")
    rpl.add_argument("--json", action="store_true",
                     help="emit the result as one JSON line")
    args = ap.parse_args(argv)
    if args.cmd == "replay":
        return run_replay(args.capsule, ab=args.ab, rung=args.rung,
                          as_json=args.json, device=args.device)
    if args.cmd != "report":
        ap.print_help()
        return 2
    if args.url:
        import urllib.request

        with urllib.request.urlopen(
            args.url.rstrip("/") + "/introspect", timeout=10
        ) as r:
            snapshot = json.loads(r.read().decode())
    elif args.file:
        with open(args.file) as f:
            snapshot = json.load(f)
    else:
        from karpenter_tpu_torch.obs import decisions

        snapshot = decisions.introspect_snapshot(k=args.k)
    if args.json:
        print(json.dumps(snapshot, indent=2, sort_keys=True))
    else:
        print(render_report(snapshot, timeline=args.timeline))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
