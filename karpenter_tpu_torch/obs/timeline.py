"""Fleet ledger: causal node-lifecycle timeline + realized-cost accounting.

The port's copy of ``karpenter_tpu/obs/timeline.py`` (imports changed).

The flight recorder (obs/trace.py) made *time* observable, the device
plane (obs/devplane.py) *compiles and padding*, the decision ledger
(obs/decisions.py) *decisions*, and the capsule plane (obs/capsule.py)
*replayability*; this module is the fifth leg — it makes the **fleet's
money and lifecycle** observable:

- **Causal node-lifecycle timeline.** Every StateNode transition —
  ``launch``/``register``/``bind``/``drain``/``evict``/``interrupt``/
  ``retire`` (the closed ``EVENT_KINDS`` enum; unknown kinds raise) —
  appends ONE bounded-ring event carrying its cause chain: the
  decision-ledger ``(site, rung, reason)`` that shipped the command, the
  round's trace id, the originating command id, and the round's replay
  capsule ref when one exists. "Why does this node exist / why did it
  die" is a query on ``/introspect`` (the ``timeline`` section) and
  ``python -m karpenter_tpu_torch.obs report --timeline``, not archaeology.
  Events raised inside an open round stage on the round's trace and only
  reach the ring when the round keeps (``Tracer._finish`` →
  ``note_round``) — an idle round that called ``obs.discard_round()``
  cannot grow the ring, mirroring the recorder's idle-round stance.
- **Realized-cost accounting.** ``observe_fleet`` integrates
  ``effective_price`` over node lifetimes (piecewise-constant between
  observations) into ``karpenter_fleet_cost_realized_total{nodepool,
  zone,capacity_type}``. Disruption commands record their
  criterion-predicted savings at confirm time (``begin_command``); when
  every replacement has launched and every retired node is gone, the
  command reconciles predicted vs realized (retired-rate minus
  launch-rate) and records one ``fleet.reconcile`` verdict. Sustained
  drift — a command outside ``KARPENTER_SAVINGS_DRIFT_TOL`` after a
  ``KARPENTER_SAVINGS_STEADY_AFTER`` in-tolerance streak — fires the
  **savings-drift** anomaly through the existing recorder (one Chrome
  dump + capsule; first-sight exempt; fires once per crossing, the same
  stance as rung-regression and solve-overhead-drift).
- **Per-tenant device-time billing.** ``devplane.record_dispatch``
  forwards every dispatch's device seconds here (``record_billing``);
  tenant resolution is explicit arg > the open round's ``tenant`` attr
  (the solver service's per-session rounds) > ``"untenanted"``. Seconds
  land on ``karpenter_tenant_device_seconds_total{tenant}`` and the
  ``karpenter_tenant_dispatch_seconds{tenant}`` histogram; the bounded
  per-tenant table (LRU at 256, evicted seconds fold into a dropped
  accumulator so totals stay exact) is the ``/usage`` endpoint's body on
  BOTH metrics servers. When a tenant's SloTracker sub-window LRU-drops,
  ``drop_tenant`` retires its histogram/quantile series
  (``Histogram.remove`` — the Gauge.remove parity the billing plane
  needed).
- **Observed interruption-rate feed.** Interrupt events count notices
  per ``(instance_type, zone)``; a retire of a noticed node counts a
  reclaim; ``observe_fleet`` integrates exposure-hours per key — the
  measured-risk input the ROADMAP's adaptive-spot item consumes
  (``interruption_rates()``; surfaced in the timeline snapshot).

All hooks are host-side: none is called from the pack loop
(``ops/kernels.py``) or ``ops/cuda_kernels.py``
(``tests/test_torch_obs.py`` scans both). Event schema, cause-chain
contract, anomaly trigger, ``/usage`` schema, and the knob table are
documented in the JAX package's deploy/README.md ("Fleet ledger").

Knobs (utils/envknobs.py accessors; re-read by ``reset()``):

- ``KARPENTER_TIMELINE_RING`` — event-ring capacity (default 4096).
- ``KARPENTER_SAVINGS_DRIFT_TOL`` — relative predicted-vs-realized
  tolerance per reconciled command (default 0.25).
- ``KARPENTER_SAVINGS_STEADY_AFTER`` — in-tolerance streak arming the
  savings-drift anomaly (default 16).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from karpenter_tpu_torch.utils.envknobs import env_float, env_int

__all__ = [
    "EVENT_KINDS",
    "FleetTimeline",
    "TIMELINE",
    "record_event",
    "record_billing",
    "note_launch",
    "pend_cause",
    "begin_command",
    "observe_fleet",
    "note_round",
    "drop_tenant",
    "interruption_rates",
    "usage_snapshot",
    "timeline_snapshot",
    "reset",
]

# the closed lifecycle-transition enum: event kinds are code constants and
# a typo must fail tests, not mint a series (the SITES stance)
EVENT_KINDS = (
    "launch", "register", "bind", "drain", "evict", "interrupt", "retire",
)

# bounded in-flight state: commands awaiting reconciliation, staged cause
# links for replacement claims, and per-tenant billing rows (the SloTracker
# _TENANT_CAP stance — client-supplied ids must not grow memory unbounded)
_COMMAND_CAP = 256
_CAUSE_CAP = 1024
_TENANT_CAP = 256


def _env_ring() -> int:
    return env_int("KARPENTER_TIMELINE_RING", 4096, minimum=16)


def _env_drift_tol() -> float:
    return env_float("KARPENTER_SAVINGS_DRIFT_TOL", 0.25, minimum=0.0)


def _env_steady_after() -> int:
    return env_int("KARPENTER_SAVINGS_STEADY_AFTER", 16, minimum=1)


def _resolve_registry(registry):
    from karpenter_tpu_torch.obs import devplane

    return devplane._resolve_registry(registry)


class FleetTimeline:
    """Process-wide fleet ledger: the event ring, the cost integrator, the
    command reconciler, the billing table, and the interruption feed. One
    module instance (``TIMELINE``) is the production default; tests
    construct their own or ``reset()`` it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._init_state()

    def _init_state(self):
        self.ring_capacity = _env_ring()
        self.drift_tol = _env_drift_tol()
        self.steady_after = _env_steady_after()
        with self._lock:
            self._ring: deque = deque(maxlen=self.ring_capacity)
            self._dropped = 0
            self._kind_counts: dict = {}  # kind -> committed events ever
            # replacement-claim name -> cause dict staged by the disruption
            # controller at command execution, popped by note_launch
            self._causes: "OrderedDict[str, dict]" = OrderedDict()
            # command id -> pending reconciliation state
            self._cmd_seq = 0
            self._commands: "OrderedDict[str, dict]" = OrderedDict()
            self._completed: deque = deque(maxlen=_COMMAND_CAP)
            # site -> {streak, violating}: the savings-drift detector (the
            # observe_quality template — in-tolerance extends the streak, a
            # violation fires only off a steady streak, then re-arms)
            self._drift: dict = {}
            # cost integrator: node name -> rate record, advanced by
            # observe_fleet between observations
            self._live: dict = {}
            self._last_now: float | None = None
            self._realized: dict = {}  # (pool, zone, ctype) -> effective $
            self._realized_total = 0.0
            self._exposure: dict = {}  # (itype, zone) -> hours
            # interruption feed
            self._notices: dict = {}  # (itype, zone) -> notices
            self._reclaims: dict = {}  # (itype, zone) -> reclaims
            self._interrupted: dict = {}  # node -> (itype, zone)
            # billing: tenant -> {device_seconds, dispatches, families}
            self._billing: "OrderedDict[str, dict]" = OrderedDict()
            self._billing_dropped = 0.0

    # -- the lifecycle event hook -----------------------------------------

    def record_event(self, kind: str, node: str, cause: dict | None = None,
                     registry=None, **attrs) -> dict:
        """One node-lifecycle transition. Inside an open round the event
        stages on the trace (committed at round close unless the round
        was discarded); with no round open it commits directly."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown timeline event kind {kind!r}")
        from karpenter_tpu_torch.obs import trace as _trace

        tr = _trace.TRACER.current_trace()
        ev = {
            "kind": kind,
            "node": str(node),
            "at": time.time(),
            "trace_id": tr.trace_id if tr is not None else None,
            "cause": dict(cause) if cause else None,
        }
        if attrs:
            ev.update(attrs)
        if tr is not None:
            tr.add_event(ev)
        else:
            self._commit([ev], registry)
        return ev

    def note_round(self, trace) -> None:
        """Commit a kept round's staged events (called by the tracer at
        round close, AFTER the idle-discard gate and the recorder dump —
        so the round's capsule ref, when one was written, rides along)."""
        events = getattr(trace, "events", None)
        if not events:
            return
        if trace.capsule_path:
            for ev in events:
                ev.setdefault("capsule", trace.capsule_path)
        self._commit(list(events), trace.registry)

    def _commit(self, events: list, registry) -> None:
        counts: dict = {}
        retired: list = []
        with self._lock:
            for ev in events:
                if len(self._ring) == self._ring.maxlen:
                    self._dropped += 1
                self._ring.append(ev)
                kind = ev["kind"]
                self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
                counts[kind] = counts.get(kind, 0) + 1
                node = ev["node"]
                if kind == "interrupt":
                    key = (ev.get("instance_type", ""), ev.get("zone", ""))
                    self._notices[key] = self._notices.get(key, 0) + 1
                    self._interrupted[node] = key
                elif kind == "retire":
                    key = self._interrupted.pop(node, None)
                    if key is not None:
                        self._reclaims[key] = self._reclaims.get(key, 0) + 1
                    retired.append(node)
        from karpenter_tpu_torch.operator import metrics as _m

        c = _resolve_registry(registry).counter(
            _m.TIMELINE_EVENTS,
            "node-lifecycle events committed to the fleet-ledger timeline",
        )
        for kind, n in counts.items():
            c.inc(n, kind=kind)
        for node in retired:
            self._note_retired(node, registry)

    # -- command reconciliation -------------------------------------------

    def pend_cause(self, name: str, cause: dict) -> None:
        """Stage a cause chain for a replacement claim the disruption
        controller just created; ``note_launch`` pops it when the claim's
        node launches so the launch event carries its provenance."""
        with self._lock:
            self._causes.pop(name, None)
            if len(self._causes) >= _CAUSE_CAP:
                self._causes.popitem(last=False)
            self._causes[name] = dict(cause)

    def begin_command(self, site: str = "", rung: str = "", reason: str = "",
                      predicted: float | None = None,
                      retired_rate: float | None = None,
                      claims=(), nodes=(), registry=None) -> str:
        """Open one disruption command's ledger entry at confirm time:
        the criterion-predicted savings, the retired candidates' summed
        effective rate, and the replacement claims / candidate nodes whose
        completion closes the reconciliation. Returns the command id the
        cause chains carry."""
        with self._lock:
            self._cmd_seq += 1
            cmd_id = f"cmd-{self._cmd_seq:05d}"
            if len(self._commands) >= _COMMAND_CAP:
                self._commands.popitem(last=False)
            self._commands[cmd_id] = {
                "site": site or "",
                "rung": rung or "",
                "reason": reason or "",
                "predicted": (
                    float(predicted) if predicted is not None else None
                ),
                "retired_rate": (
                    float(retired_rate) if retired_rate is not None else 0.0
                ),
                "launch_rate": 0.0,
                "pending_claims": set(str(c) for c in claims),
                "pending_nodes": set(str(n) for n in nodes),
                "began": time.time(),
            }
        return cmd_id

    def note_launch(self, claim: str, node: str | None = None,
                    price: float = 0.0, registry=None, **attrs) -> dict:
        """One replacement launch: pops the claim's staged cause, records
        the launch event with it, and feeds the owning command's realized
        launch rate."""
        claim = str(claim)
        with self._lock:
            cause = self._causes.pop(claim, None)
        ev = self.record_event(
            "launch", node or claim, cause=cause, registry=registry,
            claim=claim, price=round(float(price), 6), **attrs,
        )
        done: list = []
        cmd_id = (cause or {}).get("command")
        if cmd_id:
            with self._lock:
                st = self._commands.get(cmd_id)
                if st is not None:
                    st["launch_rate"] += float(price)
                    st["pending_claims"].discard(claim)
                    if not st["pending_claims"] and not st["pending_nodes"]:
                        done.append((cmd_id, self._commands.pop(cmd_id)))
        for cid, st in done:
            self._reconcile(cid, st, registry)
        return ev

    def _note_retired(self, node: str, registry) -> None:
        """A node left the fleet (retire event, or vanished between fleet
        observations — the self-healing path): commands waiting on it
        advance, completing when nothing is pending."""
        done: list = []
        with self._lock:
            for cmd_id in list(self._commands):
                st = self._commands[cmd_id]
                if node in st["pending_nodes"]:
                    st["pending_nodes"].discard(node)
                    if not st["pending_claims"] and not st["pending_nodes"]:
                        done.append((cmd_id, self._commands.pop(cmd_id)))
        for cid, st in done:
            self._reconcile(cid, st, registry)

    def _reconcile(self, cmd_id: str, st: dict, registry) -> None:
        """Close one command: realized savings = retired rate − launch
        rate; record the fleet.reconcile verdict and arm/fire the
        savings-drift detector."""
        site = st["site"]
        predicted = st["predicted"]
        realized = st["retired_rate"] - st["launch_rate"]
        rec = {
            "command": cmd_id,
            "site": site,
            "rung": st["rung"],
            "reason": st["reason"],
            "predicted": (
                round(predicted, 6) if predicted is not None else None
            ),
            "realized": round(realized, 6),
            "ok": None,
        }
        if predicted is None:
            # no criterion prediction existed (a candidate without a
            # priced offering): keep the realized record, skip the drift
            # detector — there is nothing to reconcile against
            with self._lock:
                self._completed.append(rec)
            return
        ok = abs(realized - predicted) <= self.drift_tol * max(
            abs(predicted), 1e-9
        )
        rec["ok"] = ok
        fire = None
        with self._lock:
            ent = self._drift.setdefault(
                site, {"streak": 0, "violating": False}
            )
            if ok:
                ent["streak"] += 1
                ent["violating"] = False
            else:
                if ent["streak"] >= self.steady_after and not ent["violating"]:
                    fire = ent["streak"]
                ent["violating"] = True
                ent["streak"] = 0
            self._completed.append(rec)
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        reg.counter(
            _m.FLEET_SAVINGS_PREDICTED,
            "criterion-predicted savings rate of reconciled disruption "
            "commands",
        ).inc(max(predicted, 0.0), site=site or "unknown")
        reg.counter(
            _m.FLEET_SAVINGS_REALIZED,
            "realized savings rate (retired minus launched effective "
            "price) of reconciled disruption commands",
        ).inc(max(realized, 0.0), site=site or "unknown")
        from karpenter_tpu_torch.obs import decisions as _decisions

        _decisions.record_decision(
            "fleet.reconcile",
            "within" if ok else "drift",
            "interruption" if site == "disrupt.interruption"
            else "consolidation",
            registry=reg,
        )
        if fire is not None:
            from karpenter_tpu_torch.obs import trace as _trace

            _trace.anomaly(
                "savings-drift", registry=reg, site=site or "unknown",
                command=cmd_id,
                predicted=round(predicted, 6), realized=round(realized, 6),
                held=fire,
            )

    # -- realized-cost integrator -----------------------------------------

    def observe_fleet(self, nodes, catalog, now: float, registry=None) -> dict:
        """Advance the cost integral: the PREVIOUS live set's effective
        rates accrue over ``now − last_now`` (piecewise-constant), then
        the live set rebuilds from ``nodes`` (store nodes with ``labels``)
        via ``catalog`` (a CatalogView — one per pass, not per node).
        Nodes that vanished since the last observation self-heal command
        reconciliation. Returns the live-cost summary."""
        from karpenter_tpu_torch.api import labels as wk
        from karpenter_tpu_torch.cloudprovider.types import (
            effective_price,
            risk_lambda,
        )

        lam = risk_lambda()
        new_live: dict = {}
        for node in nodes:
            labels = getattr(node, "labels", None) or {}
            off = catalog.offering(labels)
            if off is None:
                continue
            name = str(getattr(node, "name", "") or "")
            new_live[name] = {
                "pool": labels.get(wk.NODEPOOL_LABEL, ""),
                "zone": labels.get(wk.TOPOLOGY_ZONE_LABEL, ""),
                "ctype": labels.get(wk.CAPACITY_TYPE_LABEL, ""),
                "itype": labels.get(wk.INSTANCE_TYPE_LABEL, ""),
                "nominal": float(off.price),
                "effective": float(effective_price(off, lam)),
            }
        deltas: dict = {}
        vanished: list = []
        with self._lock:
            if self._last_now is not None:
                hours = max(float(now) - self._last_now, 0.0) / 3600.0
                if hours > 0.0:
                    for rec in self._live.values():
                        key = (rec["pool"], rec["zone"], rec["ctype"])
                        amt = rec["effective"] * hours
                        self._realized[key] = (
                            self._realized.get(key, 0.0) + amt
                        )
                        self._realized_total += amt
                        deltas[key] = deltas.get(key, 0.0) + amt
                        ekey = (rec["itype"], rec["zone"])
                        self._exposure[ekey] = (
                            self._exposure.get(ekey, 0.0) + hours
                        )
            vanished = [n for n in self._live if n not in new_live]
            self._live = new_live
            self._last_now = float(now)
        if deltas:
            from karpenter_tpu_torch.operator import metrics as _m

            c = _resolve_registry(registry).counter(
                _m.FLEET_COST_REALIZED,
                "effective-price dollars integrated over node lifetimes "
                "by the fleet-ledger timeline",
            )
            for (pool, zone, ctype), amt in deltas.items():
                c.inc(amt, nodepool=pool, zone=zone, capacity_type=ctype)
        for n in vanished:
            self._note_retired(n, registry)
        return self.live_cost()

    def live_cost(self) -> dict:
        """The current fleet's summed rates + the realized integral —
        ``live_rate`` (nominal) is what reconciles against the perf
        harness's end-of-leg fleet-cost sweep."""
        with self._lock:
            rate = sum(r["nominal"] for r in self._live.values())
            eff = sum(r["effective"] for r in self._live.values())
            realized = {
                "/".join(k): round(v, 6) for k, v in self._realized.items()
            }
            total = self._realized_total
            n = len(self._live)
        return {
            "live_nodes": n,
            "live_rate": round(rate, 6),
            "live_rate_effective": round(eff, 6),
            "realized": realized,
            "realized_total": round(total, 6),
        }

    # -- per-tenant device-time billing -----------------------------------

    def record_billing(self, family: str, seconds: float,
                       tenant: str | None = None, registry=None) -> str:
        """One dispatch's device seconds, attributed to a tenant. Returns
        the resolved tenant."""
        seconds = max(float(seconds), 0.0)
        if tenant is None:
            from karpenter_tpu_torch.obs import trace as _trace

            tr = _trace.TRACER.current_trace()
            if tr is not None and tr.root.attrs:
                tenant = tr.root.attrs.get("tenant")
        t = str(tenant) if tenant else "untenanted"
        with self._lock:
            rec = self._billing.pop(t, None)
            if rec is None:
                if len(self._billing) >= _TENANT_CAP:
                    _, evicted = self._billing.popitem(last=False)
                    # evicted seconds fold into the dropped accumulator so
                    # the usage total stays exact under tenant churn
                    self._billing_dropped += evicted["device_seconds"]
                rec = {"device_seconds": 0.0, "dispatches": 0,
                       "families": {}}
            self._billing[t] = rec
            rec["device_seconds"] += seconds
            rec["dispatches"] += 1
            fam = str(family)
            rec["families"][fam] = rec["families"].get(fam, 0.0) + seconds
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        reg.counter(
            _m.TENANT_DEVICE_SECONDS,
            "device seconds billed per tenant by the fleet ledger",
        ).inc(seconds, tenant=t)
        reg.histogram(
            _m.TENANT_DISPATCH_SECONDS,
            "per-dispatch device seconds by tenant",
        ).observe(seconds, tenant=t)
        return t

    def drop_tenant(self, tenant: str, slo: str | None = None,
                    registry=None) -> None:
        """A tenant's SloTracker sub-window LRU-dropped: retire its
        billing series (Histogram.remove) and, when the tracker is named,
        its rolling-quantile gauges — the label-cardinality bound under
        tenant churn."""
        t = str(tenant)
        with self._lock:
            rec = self._billing.pop(t, None)
            if rec is not None:
                self._billing_dropped += rec["device_seconds"]
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        reg.histogram(
            _m.TENANT_DISPATCH_SECONDS,
            "per-dispatch device seconds by tenant",
        ).remove(tenant=t)
        if slo:
            q = reg.gauge(
                _m.SOLVER_REQUEST_QUANTILE,
                "rolling request-latency quantiles over the SLO window",
            )
            for label in ("p50", "p95", "p99"):
                q.remove(slo=slo, tenant=t, q=label)

    # -- reads -------------------------------------------------------------

    def interruption_rates(self) -> dict:
        """Observed notices/reclaims vs exposure-hours per
        (instance_type, zone) — the adaptive-spot prior's measured-risk
        input."""
        with self._lock:
            keys = (set(self._notices) | set(self._reclaims)
                    | set(self._exposure))
            out = {}
            for k in sorted(keys):
                itype, zone = k
                n = self._notices.get(k, 0)
                r = self._reclaims.get(k, 0)
                h = self._exposure.get(k, 0.0)
                out[f"{itype}/{zone}"] = {
                    "instance_type": itype,
                    "zone": zone,
                    "notices": n,
                    "reclaims": r,
                    "exposure_hours": round(h, 6),
                    "reclaims_per_hour": (
                        round(r / h, 6) if h > 0.0 else 0.0
                    ),
                }
        return out

    def usage_snapshot(self) -> dict:
        """The ``/usage`` endpoint body: per-tenant billed device seconds
        (+ the dropped accumulator so the total matches the devplane
        dispatch-seconds ledger within rounding)."""
        with self._lock:
            tenants = {
                t: {
                    "device_seconds": round(r["device_seconds"], 6),
                    "dispatches": r["dispatches"],
                    "families": {
                        f: round(s, 6) for f, s in r["families"].items()
                    },
                }
                for t, r in self._billing.items()
            }
            dropped = self._billing_dropped
        total = sum(r["device_seconds"] for r in tenants.values()) + dropped
        from karpenter_tpu_torch.obs import devplane as _devplane

        with _devplane._STATS_LOCK:
            ledger = _devplane.STATS.get("dispatch_seconds", 0.0)
        return {
            "tenants": tenants,
            "total_device_seconds": round(total, 6),
            "dropped_device_seconds": round(dropped, 6),
            "devplane_dispatch_seconds": round(ledger, 6),
        }

    def snapshot(self, k: int = 64) -> dict:
        """The ``/introspect`` ``timeline`` section + the report CLI's
        ``--timeline`` body."""
        with self._lock:
            events = list(self._ring)[-max(int(k), 0):]
            ring = {
                "capacity": self.ring_capacity,
                "size": len(self._ring),
                "dropped": self._dropped,
                "kinds": dict(self._kind_counts),
            }
            pending = len(self._commands)
            completed = list(self._completed)[-max(int(k), 0):]
        return {
            "events": events,
            "ring": ring,
            "cost": self.live_cost(),
            "commands": {"pending": pending, "reconciled": completed},
            "interruptions": self.interruption_rates(),
            "billing": self.usage_snapshot(),
        }

    def reset(self) -> None:
        """Test isolation: clear every plane and re-read the env knobs."""
        self._init_state()


TIMELINE = FleetTimeline()


def record_event(kind: str, node: str, cause: dict | None = None,
                 registry=None, **attrs) -> dict:
    return TIMELINE.record_event(kind, node, cause=cause, registry=registry,
                                 **attrs)


def record_billing(family: str, seconds: float, tenant: str | None = None,
                   registry=None) -> str:
    return TIMELINE.record_billing(family, seconds, tenant=tenant,
                                   registry=registry)


def note_launch(claim: str, node: str | None = None, price: float = 0.0,
                registry=None, **attrs) -> dict:
    return TIMELINE.note_launch(claim, node=node, price=price,
                                registry=registry, **attrs)


def pend_cause(name: str, cause: dict) -> None:
    TIMELINE.pend_cause(name, cause)


def begin_command(site: str = "", rung: str = "", reason: str = "",
                  predicted: float | None = None,
                  retired_rate: float | None = None,
                  claims=(), nodes=(), registry=None) -> str:
    return TIMELINE.begin_command(
        site=site, rung=rung, reason=reason, predicted=predicted,
        retired_rate=retired_rate, claims=claims, nodes=nodes,
        registry=registry,
    )


def observe_fleet(nodes, catalog, now: float, registry=None) -> dict:
    return TIMELINE.observe_fleet(nodes, catalog, now, registry=registry)


def note_round(trace) -> None:
    TIMELINE.note_round(trace)


def drop_tenant(tenant: str, slo: str | None = None, registry=None) -> None:
    TIMELINE.drop_tenant(tenant, slo=slo, registry=registry)


def interruption_rates() -> dict:
    return TIMELINE.interruption_rates()


def usage_snapshot() -> dict:
    return TIMELINE.usage_snapshot()


def timeline_snapshot(k: int = 64) -> dict:
    return TIMELINE.snapshot(k)


def reset() -> None:
    TIMELINE.reset()
