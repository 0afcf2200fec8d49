"""Decision ledger: fallback-rung provenance for every hot-path ladder.

The port's copy of ``karpenter_tpu/obs/decisions.py`` (imports changed).
The port's engine rung is ``device`` where the JAX package's is ``xla``,
in the same ladder position of ``solver.route``, so ``rung-regression``
compares the same order. ``mesh.partition`` keeps its enum but has no
producer until the mesh is ported (ROADMAP.md Queue 1).

The flight recorder (obs/trace.py) made *time* observable and the device
plane (obs/devplane.py) made *compiles and padding* observable; this
module is the third leg — it makes the system's *decisions* observable.
Every hot path is a ladder of silent rungs (partitioned → replicated →
unsharded mesh, delta-advance → full-rebuild snapshots, definitive →
gallop → sequential probes, …), and a steady-state downgrade — the exact
failure mode that made the replicated mesh program a no-op for two PRs —
was invisible until someone read a bench JSON. Here, every ladder site
records exactly ONE ``(site, rung, reason)`` verdict per invocation:

======================  =================================  =========================================
site                    rungs (best first)                 recorded by
======================  =================================  =========================================
``mesh.partition``      partitioned, replicated,           ``parallel/mesh.py sharded_solve``
                        unsharded
``snapshot.advance``    delta, rebuild                     ``ops/consolidate.py SnapshotCache``
``probe.confirm``       definitive, gallop, sequential     ``controllers/disruption/methods.py``
``consolidate.global``  joint, ladder, sequential          ``controllers/disruption/methods.py``
``solver.route``        relax, mesh, native, device,       ``models/solver.py TorchSolver.solve``
                        service, host
``session.sync``        delta, resync                      ``service/solver_service.py`` (both ends)
``decode.recheck``      skip, full                         ``models/solver.py _compat_entry``
``admission.tier``      cascade, single                    ``admission/plane.py solve_round``
``admission.preempt``   confirmed, declined, skipped       ``admission/preempt.py``
``admission.gang``      atomic, routed                     ``admission/plane.py _solve_gang``
======================  =================================  =========================================

Reasons are drawn from a CLOSED enum per site (``SITES[site]["reasons"]``)
so the ``karpenter_decision_total{site,rung,reason}`` label cardinality is
bounded: an unknown reason clamps to ``"other"`` instead of minting a new
series (``canonical_reason``). Unknown sites/rungs raise — they are code
constants, and a typo must fail tests, not mint a series. (The JAX
package checks every producer's literal reason against ``SITES`` with
graftlint's GL502; the port's static analysis is ROADMAP.md Queue 1
item 4.)

Every record also:

- lands on the open round's flight-recorder trace (``Trace.add_decision``)
  as structured attrs, so the Chrome dump of an anomalous round shows
  which rungs it ran (``otherData.decisions``);
- feeds the **rung-regression anomaly**: a site that held a top rung for
  ``KARPENTER_RUNG_STEADY_AFTER`` (16) consecutive invocations and then
  records a strictly lower rung fires ``rung-regression`` through the
  existing one-dump-per-round machinery — the same stance as
  cold-compile-in-steady-state. A site's first-ever record can never fire
  (first-sight exemption), reasons a site marks ``benign`` (a session's
  initial upload for a new shape family, a calibrated small-batch routing
  flip) neither fire nor break the held streak (expected universe growth,
  mirroring the compile ledger's first-of-family exemption), and after
  firing the downgraded rung becomes the new held rung, so a persistent
  downgrade dumps once, not per round.

The **solve-quality account** (``record_quality``) tracks per-solve nodes
against the pods-cap floor the solver already computes: the ratio lands on
the ``karpenter_solve_overhead_ratio`` gauge and a per-shape-family series,
and a steady-state drift (ratio held within ``KARPENTER_QUALITY_DRIFT_TOL``
of the family's best for ``KARPENTER_QUALITY_STEADY_AFTER`` solves, then
exceeds it) fires the ``solve-overhead-drift`` anomaly once per crossing.
Families below ``KARPENTER_QUALITY_MIN_FLOOR`` (8) feed the gauge/series
but not the drift detector — toy solves must not arm it.

Introspection: ``introspect_snapshot()`` is the ``/introspect`` endpoint's
JSON body (metrics server AND the solver service's --metrics-port): per-
site rung mixes, the last-K rounds' rung summaries (fed by the tracer at
round close), the quality series, per-tenant rung mixes (bounded LRU, the
SloTracker stance), and the recorder's retained anomalous rounds.
``python -m karpenter_tpu_torch.obs report`` renders it for a human.

All hooks are host-side: none is called from the pack loop
(``ops/kernels.py``) or ``ops/cuda_kernels.py``
(``tests/test_torch_obs.py`` scans both). Site/rung/reason semantics
are documented in the JAX package's deploy/README.md ("Decision
plane").

The ``fleet.reconcile`` site is produced by the fleet ledger
(:mod:`karpenter_tpu_torch.obs.timeline`): one verdict per reconciled
disruption command, with the savings-drift anomaly owning that site's
steady-streak story — see deploy/README.md ("Fleet ledger").
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

__all__ = [
    "SITES",
    "OTHER_REASON",
    "DecisionLedger",
    "DECISIONS",
    "record_decision",
    "record_quality",
    "canonical_reason",
    "rung_rank",
    "note_round",
    "counts",
    "rung_delta",
    "introspect_snapshot",
    "reset",
    "SOLVER_FALLBACK_REASONS",
]

# the catchall every site's enum carries: unknown reasons clamp here so
# client-supplied or exception-derived strings can never mint new series
OTHER_REASON = "other"

# The closed site registry. ``rungs`` are ordered BEST first — rank order
# is what the rung-regression anomaly and bench.py's sentinel compare —
# and ``reasons`` is the complete label universe for the site (producers'
# literal reason strings are pinned against these sets by
# tests/test_decisions.py, so the scattered fallback-cause strings and the
# ledger can never drift apart).
SITES = {
    "mesh.partition": {
        # parallel/mesh.py sharded_solve: the partitioned formulation, the
        # replicated exact fallback, or the plain unsharded kernel.
        # Replicated reasons are plan_shards' refusal causes verbatim.
        "rungs": ("partitioned", "replicated", "unsharded"),
        "reasons": frozenset({
            "ok", "partition-disabled", "degenerate-mesh", "existing-nodes",
            "min-values", "nodepool-limits", "single-bin-groups",
            "topology-classes", "too-few-groups", "no-need", "single-slice",
            "no-plan", "repair-bound", OTHER_REASON,
        }),
    },
    "snapshot.advance": {
        # ops/consolidate.py SnapshotCache: a stale held bundle either
        # delta-advances or is displaced by a full rebuild. Rebuild
        # reasons are the inexpressible-delta causes.
        "rungs": ("delta", "rebuild"),
        "reasons": frozenset({
            "ok", "journal-gap", "opaque-entry", "plan", "limits",
            "ineligible-pending", "unseen-signature", "unseen-pending",
            "churn", "candidate-widened", OTHER_REASON,
        }),
    },
    "probe.confirm": {
        # controllers/disruption/methods.py: how a consolidation method's
        # probe ladder resolved — definitive (one confirming simulation),
        # gallop (device seed + sequential recovery), or the reference's
        # sequential search outright. joint-seeded = the answer came from
        # the round's joint dispatch (ops/consolidate.py JointSeed)
        # without a second device dispatch — the short-circuit's
        # accounted, never-silent skipped-probe path.
        "rungs": ("definitive", "gallop", "sequential"),
        "reasons": frozenset({
            "ok", "non-definitive", "inexpressible", "probe-error",
            "no-device", "joint-seeded", OTHER_REASON,
        }),
    },
    "consolidate.global": {
        # controllers/disruption/methods.py GlobalConsolidation: the joint
        # device-solved retirement shipped (joint), handed the round to
        # the per-candidate ladder with a cause (ladder — confirm
        # disagreement, repair overflow, topology plan, or simply nothing
        # to retire), or never ran a device solve at all (sequential).
        # Workload-driven hand-offs are benign; confirm-mismatch,
        # repair-bound, probe-error, and inexpressible stay armed — a
        # steady 2k fleet quietly descending to the ladder every round is
        # exactly the regression this site exists to catch.
        # joint-noop-fenced = the joint dispatch PROVED round-wide
        # no-retirement on a mid-transition snapshot and the controller
        # closed the round without running the MultiNode/SingleNode
        # probes (the short-circuit) — workload-driven, benign.
        # relax / relax-rounded = the LP relaxation rung (ops/relax.py)
        # selected the shipped set (exactly at the LP bound / with the
        # rounding window shedding below it); relax-fallback = relax
        # attempted and declined, the FFD ladder shipped the round
        # (RELAX_STATS pins the cause). All three ship a command at the
        # best rung, so like "ok" they stay armed rather than benign.
        # replace = the joint REPLACE program (multi-claim rows,
        # KARPENTER_REPLACE_MAX_CLAIMS>1) shipped a retirement the m->1
        # delete rows would have stranded — armed, same stance as relax.
        "rungs": ("joint", "ladder", "sequential"),
        "reasons": frozenset({
            "ok", "no-retirement", "non-definitive", "confirm-mismatch",
            "repair-bound", "topology-plan", "inexpressible",
            "probe-error", "no-device", "disabled", "too-few-candidates",
            "joint-noop-fenced", "relax", "relax-rounded",
            "relax-fallback", "replace", OTHER_REASON,
        }),
        "benign": frozenset({
            "no-retirement", "non-definitive", "topology-plan", "disabled",
            "too-few-candidates", "no-device", "joint-noop-fenced",
        }),
    },
    "disrupt.interruption": {
        # controllers/disruption/methods.py InterruptionDrain: one verdict
        # per notice-bearing round — the replacement was solved and
        # launched BEFORE the drain (proactive; delete-only when the
        # survivors absorb every displaced pod), the replacement solve
        # could not place the pods so the node drains bare and the
        # provisioner rescues post-drain (reactive), or the deadline left
        # no time for a replacement at all and the round degraded to an
        # immediate drain (degraded). Degradations are cloud-driven (a
        # short-lead notice) but a fleet whose proactive path silently
        # dies — every notice degrading — is exactly what this site's
        # regression tracker exists to catch, so nothing is benign.
        "rungs": ("proactive", "reactive", "degraded"),
        "reasons": frozenset({
            "ok", "delete-only", "reactive-fallback", "deadline-degraded",
            OTHER_REASON,
        }),
    },
    "fleet.reconcile": {
        # obs/timeline.py FleetTimeline._reconcile: one verdict per
        # disruption command whose replacements all launched and whose
        # retired nodes all left the fleet — realized savings (retired
        # rate minus launch rate) within the KARPENTER_SAVINGS_DRIFT_TOL
        # band of the criterion prediction, or drifting. Every reason is
        # benign: the savings-drift anomaly (obs/timeline.py) owns the
        # steady-streak regression story for this site, so the generic
        # rung-regression detector must not double-fire beside it. See
        # deploy/README.md "Fleet ledger".
        "rungs": ("within", "drift"),
        "reasons": frozenset({
            "ok", "consolidation", "interruption", OTHER_REASON,
        }),
        "benign": frozenset({
            "ok", "consolidation", "interruption", OTHER_REASON,
        }),
    },
    "solver.route": {
        # models/solver.py TorchSolver.solve: which engine ran the kernel
        # (or that no kernel ran at all — the host FFD rung). relax =
        # the LP relaxation floor (ops/relax.py lp_bin_floor) tightened
        # the bin estimate that steered the completed solve — the rung
        # outranks the engines because the relaxation certificate, not
        # engine routing, decided the solve's shape.
        "rungs": ("relax", "mesh", "native", "device", "service", "host"),
        "reasons": frozenset({
            "ok", "small-batch", "work-floor", "cpu-backend", "no-templates",
            "no-eligible", "no-device-groups", "remote-fallback",
            OTHER_REASON,
        }),
        # calibrated routing flips (a small batch after a big-batch streak,
        # the work floor, a bigger batch leaving the native crossover) are
        # the router doing its job, not a regression; the host-rung reasons
        # and remote-fallback stay armed
        "benign": frozenset({"ok", "small-batch", "work-floor",
                             "cpu-backend"}),
    },
    "session.sync": {
        # service/solver_service.py, both ends: a session round ships a
        # delta, or a full snapshot (initial upload, client-detected
        # journal drift, or a server resync demand by exception class).
        "rungs": ("delta", "resync"),
        "reasons": frozenset({
            "ok", "initial", "journal-gap", "opaque-delta",
            "ResyncRequired", "SessionExpired", "UnknownSession",
            "OutOfOrderDelta", OTHER_REASON,
        }),
        # a first upload for a NEW shape family (or one the client's
        # bounded family LRU evicted and re-registered) is expected
        # universe growth, not protocol drift — the same stance as the
        # compile ledger's first-of-family exemption. It neither fires nor
        # breaks the held delta streak.
        "benign": frozenset({"initial"}),
    },
    "decode.recheck": {
        # models/solver.py _compat_entry: the decoder's merged-requirement
        # re-check was provably skippable, or ran in full (and why the
        # exactness argument did not apply).
        "rungs": ("skip", "full"),
        "reasons": frozenset({
            "ok", "no-candidates", "disabled", "offering-keys",
            "group-key-overlap", "non-decomposable", OTHER_REASON,
        }),
    },
    "admission.tier": {
        # admission/plane.py: a live batch with priority markers collapsed
        # its gang-free tiers into ONE device dispatch with on-device tier
        # fencing (fused — deploy/README.md "Fused cluster round"), ran
        # the per-tier cascade (host rung, gang-interleaved, or
        # KARPENTER_FUSED_ROUND=0), or collapsed to the plain single
        # solve. The tier count is workload-driven, so every reason is
        # benign — the site exists for the mix, not the regression
        # detector.
        "rungs": ("fused", "cascade", "single"),
        "reasons": frozenset({
            "ok", "single-tier", "disabled", OTHER_REASON,
        }),
        "benign": frozenset({"ok", "single-tier", "disabled", OTHER_REASON}),
    },
    "admission.preempt": {
        # admission/preempt.py: one verdict per unschedulable high-tier pod
        # the preemption ladder examined — evictions shipped after a
        # confirming simulation, declined (probe/confirm said no), or
        # skipped before any counterfactual ran. Workload-driven declines
        # are benign; confirm-failed (probe-vs-host disagreement) and
        # probe-error stay armed.
        "rungs": ("confirmed", "declined", "skipped"),
        "reasons": frozenset({
            "ok", "no-victims", "policy-never", "no-feasible-node",
            "confirm-failed", "pdb-blocked", "ineligible-spec", "disabled",
            "probe-error", OTHER_REASON,
        }),
        "benign": frozenset({
            "no-victims", "policy-never", "no-feasible-node",
            "ineligible-spec", "disabled",
        }),
    },
    "admission.gang": {
        # admission/gangs.py via plane._solve_gang: one verdict per gang —
        # the whole group landed atomically, or the whole group
        # host-routed with a cause (never a partial bind). Capacity-driven
        # routes are benign; trial-error (the commit diverged from its
        # trial) stays armed.
        "rungs": ("atomic", "routed"),
        "reasons": frozenset({
            "ok", "infeasible", "budget-starved", "oversize", "trial-error",
            OTHER_REASON,
        }),
        "benign": frozenset({"infeasible", "budget-starved", "oversize"}),
    },
}

# RemoteSolver fallback reasons (karpenter_solver_remote_fallbacks_total):
# not a ladder site of their own, but the same bounded-cardinality stance —
# server exception classes outside this set clamp to "server-error" so a
# novel server bug can't mint unbounded label series (satellite of the
# session.sync enum; clamped in service/solver_service.py _fallback).
SOLVER_FALLBACK_REASONS = frozenset({
    "transport", "transport-retryable", "server-error",
    "ResyncRequired", "SessionExpired", "UnknownSession", "OutOfOrderDelta",
    "TenantBudgetExceeded", "CrossTenantBleed",
    "ValueError", "RuntimeError", "KeyError", "AssertionError",
})


# the shared env-knob trio (utils/envknobs.py — the same parser the
# service plane's knobs ride, so clamp/garbage behavior cannot drift)
from karpenter_tpu_torch.utils.envknobs import env_float as _env_float  # noqa: E402
from karpenter_tpu_torch.utils.envknobs import env_int as _env_int  # noqa: E402


def canonical_reason(site: str, reason) -> str:
    """Clamp ``reason`` into the site's closed enum (unknown → "other").
    Empty/None reads as "ok" — a rung taken cleanly needs no cause."""
    spec = SITES.get(site)
    r = str(reason) if reason else "ok"
    if spec is None or r in spec["reasons"]:
        return r
    return OTHER_REASON


def rung_rank(site: str, rung: str) -> int:
    """Position of ``rung`` in the site's best-first order (lower is
    better); unknown rungs rank past the end so comparisons stay total."""
    rungs = SITES.get(site, {}).get("rungs", ())
    try:
        return rungs.index(rung)
    except ValueError:
        return len(rungs)


def _resolve_registry(registry):
    from karpenter_tpu_torch.obs import devplane

    return devplane._resolve_registry(registry)


# bounded per-tenant rung-mix views, mirroring the SloTracker cap: tenant
# ids are client-supplied and must not grow ledger memory without limit
_TENANT_CAP = 256


class DecisionLedger:
    """Process-wide ``(site, rung, reason)`` accounting + the streak state
    behind the rung-regression anomaly. One module instance
    (``DECISIONS``) is the production default; tests construct their own
    or ``reset()`` it."""

    def __init__(self, steady_after: int | None = None):
        self._lock = threading.Lock()
        self._counts: dict = {}  # (site, rung, reason) -> int
        self._last: dict = {}  # site -> (rung, reason)
        # site -> [held rung index, consecutive records at or above it]
        self._held: dict = {}
        self._tenants: "OrderedDict[str, dict]" = OrderedDict()
        self._rounds: deque = deque(
            maxlen=_env_int("KARPENTER_DECISION_RING", 64, minimum=1))
        self.steady_after = (
            steady_after if steady_after is not None
            else _env_int("KARPENTER_RUNG_STEADY_AFTER", 16, minimum=1)
        )
        # solve-quality account: shape family -> drift-detector state
        self._q: dict = {}
        self._q_series: deque = deque(maxlen=256)
        self.q_steady_after = _env_int("KARPENTER_QUALITY_STEADY_AFTER", 16, minimum=1)
        self.q_tol = _env_float("KARPENTER_QUALITY_DRIFT_TOL", 0.25)
        self.q_min_floor = _env_int("KARPENTER_QUALITY_MIN_FLOOR", 8,
                                    minimum=0)

    # -- the one hook every ladder site calls -----------------------------

    def record(self, site: str, rung: str, reason: str = "ok",
               registry=None, tenant: str | None = None) -> str:
        """One ladder verdict. Returns the canonical (possibly clamped)
        reason. Unknown sites/rungs raise — they are code constants."""
        spec = SITES.get(site)
        if spec is None:
            raise ValueError(f"unknown decision site {site!r}")
        if rung not in spec["rungs"]:
            raise ValueError(f"unknown rung {rung!r} for site {site}")
        reason = canonical_reason(site, reason)
        idx = spec["rungs"].index(rung)
        fire = None
        with self._lock:
            key = (site, rung, reason)
            self._counts[key] = self._counts.get(key, 0) + 1
            self._last[site] = (rung, reason)
            held = self._held.get(site)
            if held is None or idx < held[0]:
                # first sight, or an upgrade: the better rung starts a
                # fresh streak (first-sight exemption falls out here — no
                # prior streak exists to regress from)
                self._held[site] = [idx, 1]
            elif idx == held[0]:
                held[1] += 1
            elif reason in spec.get("benign", ()):
                # expected-growth / calibrated-routing downgrade (e.g. a
                # session's initial upload for a new shape family, a
                # small batch routing native mid-device-streak): neither an
                # anomaly nor a streak break — the held rung survives the
                # interruption, so a REAL downgrade after it still fires
                pass
            else:
                if held[1] >= self.steady_after:
                    fire = (spec["rungs"][held[0]], held[1])
                self._held[site] = [idx, 1]
            if tenant is not None:
                mix = self._tenants.pop(tenant, None)
                if mix is None:
                    if len(self._tenants) >= _TENANT_CAP:
                        self._tenants.pop(next(iter(self._tenants)))
                    mix = {}
                self._tenants[tenant] = mix
                smix = mix.setdefault(site, {})
                smix[rung] = smix.get(rung, 0) + 1
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        reg.counter(
            _m.DECISION_TOTAL,
            "ladder verdicts recorded by the decision ledger "
            "(one per site invocation)",
        ).inc(site=site, rung=rung, reason=reason)
        from karpenter_tpu_torch.obs import trace as _trace

        tr = _trace.TRACER.current_trace()
        if tr is not None:
            tr.add_decision(site, rung, reason)
        if fire is not None:
            # the one bad round the flight recorder exists for: a site
            # that had settled on a top rung just downgraded — dump the
            # round that paid it (once; the new rung is now the held one)
            _trace.anomaly(
                "rung-regression", registry=reg, site=site,
                from_rung=fire[0], to_rung=rung, reason=reason,
                held=fire[1],
            )
        return reason

    # -- solve-quality account --------------------------------------------

    def observe_quality(self, nodes: int, floor: int, family=None,
                        registry=None) -> float:
        """One solve's node count vs. the solver's pods-cap floor (its
        demand lower bound). Returns the overhead ratio."""
        nodes = max(int(nodes), 0)
        floor = max(int(floor), 0)
        ratio = nodes / max(floor, 1)
        fam = str(family) if family is not None else "default"
        fire = None
        with self._lock:
            self._q_series.append({
                "family": fam, "nodes": nodes, "floor": floor,
                "ratio": round(ratio, 4), "at": time.time(),
            })
            if floor >= self.q_min_floor:
                ent = self._q.get(fam)
                if ent is None:
                    ent = self._q[fam] = {
                        "baseline": ratio, "streak": 0, "violating": False,
                    }
                if ratio < ent["baseline"]:
                    ent["baseline"] = ratio
                if ratio <= ent["baseline"] * (1.0 + self.q_tol):
                    ent["streak"] += 1
                    ent["violating"] = False
                else:
                    if (ent["streak"] >= self.q_steady_after
                            and not ent["violating"]):
                        fire = (ent["baseline"], ent["streak"])
                    ent["violating"] = True
                    ent["streak"] = 0
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        reg.gauge(
            _m.SOLVE_OVERHEAD_RATIO,
            "per-solve nodes over the solver's pods-cap floor "
            "(1.0 = packed to the demand lower bound)",
        ).set(ratio, family=fam)
        if fire is not None:
            from karpenter_tpu_torch.obs import trace as _trace

            _trace.anomaly(
                "solve-overhead-drift", registry=reg, family=fam,
                ratio=round(ratio, 4), baseline=round(fire[0], 4),
                held=fire[1],
            )
        return ratio

    # -- round summaries (fed by the tracer at round close) ---------------

    def note_round(self, trace) -> None:
        """Fold a closed round trace's decisions into the last-K ring the
        introspection surface serves."""
        decs = getattr(trace, "decisions", None)
        if not decs:
            return
        summary: dict = {}
        for (site, rung, reason), n in decs.items():
            srow = summary.setdefault(site, {})
            rrow = srow.setdefault(rung, {})
            rrow[reason] = rrow.get(reason, 0) + n
        with self._lock:
            self._rounds.append({
                "round": trace.name,
                "trace_id": trace.trace_id,
                "wall_start": trace.wall_start,
                "decisions": summary,
            })

    # -- reads -------------------------------------------------------------

    def counts(self) -> dict:
        """{(site, rung, reason): n} snapshot — the perf harness deltas
        this per row."""
        with self._lock:
            return dict(self._counts)

    def site_summary(self) -> dict:
        """{site: {last, held, rungs{rung{reason: n}}}} over the process
        lifetime."""
        with self._lock:
            items = list(self._counts.items())
            last = dict(self._last)
            held = {s: list(v) for s, v in self._held.items()}
        out: dict = {}
        for (site, rung, reason), n in items:
            srow = out.setdefault(site, {"rungs": {}})
            rrow = srow["rungs"].setdefault(rung, {})
            rrow[reason] = rrow.get(reason, 0) + n
        for site, srow in out.items():
            if site in last:
                srow["last"] = {"rung": last[site][0],
                                "reason": last[site][1]}
            hv = held.get(site)
            if hv is not None:
                rungs = SITES[site]["rungs"]
                srow["held"] = {"rung": rungs[hv[0]], "streak": hv[1]}
        return out

    def quality_summary(self) -> dict:
        with self._lock:
            series = list(self._q_series)
            fams = {
                f: {"baseline": round(e["baseline"], 4),
                    "streak": e["streak"], "violating": e["violating"]}
                for f, e in self._q.items()
            }
        return {"series": series, "families": fams}

    def tenant_mix(self) -> dict:
        with self._lock:
            return {t: {s: dict(r) for s, r in mix.items()}
                    for t, mix in self._tenants.items()}

    def rounds(self, k: int | None = None) -> list:
        with self._lock:
            rounds = list(self._rounds)
        return rounds[-k:] if k else rounds

    def clear(self):
        with self._lock:
            self._counts.clear()
            self._last.clear()
            self._held.clear()
            self._tenants.clear()
            self._rounds.clear()
            self._q.clear()
            self._q_series.clear()


DECISIONS = DecisionLedger()


def record_decision(site: str, rung: str, reason: str = "ok",
                    registry=None, tenant: str | None = None) -> str:
    return DECISIONS.record(site, rung, reason, registry=registry,
                            tenant=tenant)


def record_quality(nodes: int, floor: int, family=None,
                   registry=None) -> float:
    return DECISIONS.observe_quality(nodes, floor, family=family,
                                     registry=registry)


def note_round(trace) -> None:
    DECISIONS.note_round(trace)


def counts() -> dict:
    return DECISIONS.counts()


def rung_delta(before: dict, after: dict) -> dict:
    """{site: {rung: n}} of the records between two ``counts()`` snapshots
    — the per-row rung summary the perf harness and bench.py embed."""
    out: dict = {}
    for (site, rung, _reason), n in after.items():
        d = n - before.get((site, rung, _reason), 0)
        if d:
            srow = out.setdefault(site, {})
            srow[rung] = srow.get(rung, 0) + d
    return out


def introspect_snapshot(k: int = 16) -> dict:
    """The ``/introspect`` endpoint body: per-site rung mixes, the last-K
    rounds' rung summaries, the quality account, per-tenant rung mixes,
    the flight recorder's retained anomalous rounds, the replay capsules
    written by this process (obs/capsule.py), and the fleet ledger's
    timeline section (obs/timeline.py)."""
    from karpenter_tpu_torch.obs import capsule as _capsule
    from karpenter_tpu_torch.obs import timeline as _timeline
    from karpenter_tpu_torch.obs import trace as _trace

    anomalies = []
    for tr in _trace.RECORDER.traces():
        if not tr.anomalies:
            continue
        anomalies.append({
            "round": tr.name,
            "trace_id": tr.trace_id,
            "kinds": [kind for kind, _, _ in tr.anomalies],
            "dump": tr.dump_path,
            "capsule": tr.capsule_path,
        })
    return {
        "sites": DECISIONS.site_summary(),
        "rounds": DECISIONS.rounds(k),
        "quality": DECISIONS.quality_summary(),
        "tenants": DECISIONS.tenant_mix(),
        "anomalies": anomalies[-k:],
        "capsules": _capsule.index(k),
        "timeline": _timeline.timeline_snapshot(k),
    }


def reset():
    """Test isolation: clear the ledger and re-read the env knobs."""
    DECISIONS.clear()
    DECISIONS.steady_after = _env_int("KARPENTER_RUNG_STEADY_AFTER", 16, minimum=1)
    DECISIONS.q_steady_after = _env_int("KARPENTER_QUALITY_STEADY_AFTER", 16, minimum=1)
    DECISIONS.q_tol = _env_float("KARPENTER_QUALITY_DRIFT_TOL", 0.25)
    DECISIONS.q_min_floor = _env_int("KARPENTER_QUALITY_MIN_FLOOR", 8,
                                     minimum=0)
    return DECISIONS
