"""Device-plane telemetry: compile ledger, padding-waste accounting, SLO.

The port's copy of ``karpenter_tpu/obs/devplane.py`` (imports changed).
The producers key each family as the JAX package does (the padded shapes
and static parameters), so one dispatch sequence gives the same cold and
warm verdicts in both packages. On the card no XLA compile stands behind
a cold key: its seconds are the first dispatch — CUDA's first use and,
once per process, the build or load of ``csrc/compat.cu``. The
``record_shard_*`` functions are fed by the mesh (``parallel/mesh.py``).

The flight recorder (obs/trace.py) explains where a round's *host* wall
clock goes; this module covers the three blind spots the device plane
still had:

- **Compile ledger.** Every jit family the product dispatches — the
  packed solve kernel (``solve.kernel``), the batched consolidation probe
  (``probe.kernel``), the mesh-sharded solve (``mesh.shard``) — reports
  each dispatch here with the executable-identifying key (shape bucket +
  static params). A key never seen before is a **cold compile**: the
  dispatch wall time (which includes XLA trace+compile for a cold key)
  lands in ``karpenter_compile_seconds{family}``,
  ``karpenter_compile_events_total{family}`` counts it, and
  ``karpenter_compile_families_resident{family}`` gauges the live key
  cardinality. A cold compile that interrupts a long warm streak (the
  key universe had stopped growing — steady state) fires the
  ``cold-compile-in-steady-state`` anomaly, so the flight recorder dumps
  the round that paid the surprise compile. The streak threshold is
  ``KARPENTER_COMPILE_STEADY_AFTER`` (default 16 warm dispatches).
- **Padding-waste accounting.** Every pow-2-ladder dispatch (solver bin
  axis, probe row chunks, mesh shard axes) records padded vs. actual
  extents; the wasted-work fraction ``1 - actual/padded`` feeds the
  ``karpenter_pad_waste_ratio{site}`` histogram and the ``STATS``
  aggregate the perf harness surfaces per row (``pad_waste_ratio``).
- **SLO trackers.** Named rolling windows (:class:`SloTracker`) over
  request durations/outcomes: ``karpenter_solver_request_seconds
  {outcome}`` histograms, rolling p50/p95/p99 gauges
  (``karpenter_solver_request_quantile_seconds{slo,q}``), and an
  error-budget burn counter (``karpenter_slo_error_budget_burn_total
  {slo}``) that ticks for every objective-violating request (error
  outcome, or latency above the tracker's latency SLO). The
  ``/slo`` endpoint on the metrics server (karpenter_tpu/__main__.py
  ``serve_metrics``) serves ``slo_snapshot()`` + the ledger summary as
  JSON. The gRPC solver service (service/solver_service.py) is the first
  producer: one linked server-side round trace per request, client trace
  ids carried in request meta.

All hooks are host-side: none is called from the pack loop
(``ops/kernels.py``) or ``ops/cuda_kernels.py``
(``tests/test_torch_obs.py`` scans both). Metric families are
documented in the JAX package's deploy/README.md ("Device-plane & SLO
telemetry").
"""

from __future__ import annotations

import threading
from collections import deque

from karpenter_tpu_torch.utils.envknobs import env_int

__all__ = [
    "CompileLedger",
    "LEDGER",
    "SloTracker",
    "STATS",
    "record_bin_growth",
    "record_dispatch",
    "record_padding",
    "record_shard_balance",
    "record_shard_fallback",
    "record_shard_overlap",
    "record_shard_repair",
    "slo_tracker",
    "slo_snapshot",
    "reset",
]

# process-wide accounting the perf harness deltas per solve
# (snapshot-and-diff readers). Mutations hold _STATS_LOCK: dict-entry +=
# is a read-modify-write that interleaves across the solver service's
# gRPC worker threads, and a lost increment silently undercounts the
# /slo summary and the perf-row deltas.
STATS = {
    "cold_compiles": 0,
    "compile_ms": 0.0,
    "warm_dispatches": 0,
    "pad_dispatches": 0,
    "pad_cells_actual": 0.0,
    "pad_cells_padded": 0.0,
    # partitioned mesh solve (parallel/mesh.py): host tensorize wall time
    # hidden under in-flight shard programs (the pipeline's overlap),
    # straddling pods re-packed by the bounded repair pass, and fallbacks
    # out of the partitioned rung
    "shard_overlap_ms": 0.0,
    "shard_repair_pods": 0,
    "shard_fallbacks": 0,
    # max/mean hybrid shard weight of the most recent partition plan
    # (1.0 = perfectly balanced; the ROADMAP's next mesh lever)
    "shard_balance_ratio": 0.0,
    # on-device doublings of the solve's merged bin axis (the solver's
    # doubled re-run) — the fused-round lever that keeps axis exhaustion
    # off the host repair path; perf rows surface it as bin_growth_events
    "bin_growths": 0,
    # total device seconds across EVERY dispatch (cold + warm) — the
    # ground-truth total the fleet ledger's per-tenant billing
    # (obs/timeline.py /usage) must sum to within rounding
    "dispatch_seconds": 0.0,
}
_STATS_LOCK = threading.Lock()


def _env_steady_after() -> int:
    return env_int("KARPENTER_COMPILE_STEADY_AFTER", 16, minimum=1)


def _resolve_registry(registry):
    """Explicit registry > the open round's registry > the process
    default — the same resolution order ``anomaly()`` uses, so ledger
    metrics land where the round's other families do."""
    if registry is not None:
        return registry
    from karpenter_tpu_torch.obs import trace as _trace

    tr = _trace.TRACER.current_trace()
    if tr is not None and tr.registry is not None:
        return tr.registry
    from karpenter_tpu_torch.operator import metrics as _m

    return _m.REGISTRY


class CompileLedger:
    """Which jit executables exist, and when a new one appears.

    ``record_dispatch`` is called host-side after every kernel dispatch
    with the family name and the key that identifies the compiled
    executable (shape bucket + static params — the same tuple the
    kernel caches key on). First sight of a key is a cold-compile event;
    every other dispatch extends the warm streak that arms the
    steady-state anomaly."""

    def __init__(self, steady_after: int | None = None):
        self._lock = threading.Lock()
        self._keys: dict = {}  # family -> set of executable keys
        self._warm_streak = 0
        self.steady_after = (
            steady_after if steady_after is not None else _env_steady_after()
        )

    def record_dispatch(self, family: str, key, seconds: float,
                        registry=None, tenant: str | None = None) -> bool:
        """Note one dispatch; returns True when it was a cold compile.
        ``tenant`` attributes the dispatch's device seconds to a tenant on
        the fleet ledger's billing plane (obs/timeline.py); None lets the
        ledger resolve the open round's tenant attr (the solver service's
        per-session rounds) before falling back to "untenanted"."""
        with self._lock:
            seen = self._keys.setdefault(family, set())
            cold = key not in seen
            first_of_family = cold and not seen
            if cold:
                seen.add(key)
                streak, self._warm_streak = self._warm_streak, 0
                resident = len(seen)
            else:
                self._warm_streak += 1
        from karpenter_tpu_torch.obs import timeline as _timeline

        _timeline.record_billing(family, seconds, tenant=tenant,
                                 registry=registry)
        if not cold:
            with _STATS_LOCK:
                STATS["warm_dispatches"] += 1
                STATS["dispatch_seconds"] += seconds
            return False
        with _STATS_LOCK:
            STATS["cold_compiles"] += 1
            STATS["compile_ms"] += seconds * 1000.0
            STATS["dispatch_seconds"] += seconds
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        reg.counter(
            _m.COMPILE_EVENTS,
            "cold-compile events observed by the device-plane compile ledger",
        ).inc(family=family)
        reg.histogram(
            _m.COMPILE_SECONDS,
            "wall time of dispatches that paid an XLA trace+compile",
        ).observe(seconds, family=family)
        reg.gauge(
            _m.COMPILE_FAMILIES,
            "live executable cardinality per jit family",
        ).set(resident, family=family)
        if streak >= self.steady_after and not first_of_family:
            # the key universe had stopped growing and a compile still
            # happened: the one bad round the flight recorder exists for.
            # A family's FIRST key ever is exempt — a subsystem coming
            # online late (the first probe round, the first mesh solve) is
            # expected universe growth, not churn (the same stance as the
            # snapshot-rebuild trigger's first-build exemption)
            from karpenter_tpu_torch.obs import trace as _trace

            _trace.anomaly(
                "cold-compile-in-steady-state", registry=reg, family=family,
                warm_streak=streak, compile_ms=round(seconds * 1000.0, 3),
            )
        return True

    def families(self) -> dict:
        """family -> resident executable count."""
        with self._lock:
            return {fam: len(keys) for fam, keys in self._keys.items()}

    def warm_streak(self) -> int:
        with self._lock:
            return self._warm_streak

    def snapshot(self) -> dict:
        with _STATS_LOCK:
            cold, ms = STATS["cold_compiles"], STATS["compile_ms"]
        return {
            "families": self.families(),
            "warm_streak": self.warm_streak(),
            "steady_after": self.steady_after,
            "cold_compiles": cold,
            "compile_ms": round(ms, 3),
        }

    def clear(self):
        with self._lock:
            self._keys.clear()
            self._warm_streak = 0


LEDGER = CompileLedger()


def record_dispatch(family: str, key, seconds: float, registry=None,
                    tenant: str | None = None) -> bool:
    return LEDGER.record_dispatch(family, key, seconds, registry=registry,
                                  tenant=tenant)


def record_padding(site: str, actual, padded, registry=None) -> float:
    """One pow-2-ladder dispatch's padded vs. actual work extents (cell
    counts, e.g. G*T*B vs Gp*Tp*Bp). Returns the wasted-work fraction."""
    actual = max(float(actual), 0.0)
    padded = max(float(padded), 0.0)
    ratio = 0.0 if padded <= 0.0 else min(max(1.0 - actual / padded, 0.0), 1.0)
    with _STATS_LOCK:
        STATS["pad_dispatches"] += 1
        STATS["pad_cells_actual"] += actual
        STATS["pad_cells_padded"] += padded
    from karpenter_tpu_torch.operator import metrics as _m

    _resolve_registry(registry).histogram(
        _m.PAD_WASTE_RATIO,
        "wasted-work fraction of pow-2-padded device dispatches "
        "(1 - actual/padded extents)",
        buckets=_m.PAD_WASTE_BUCKETS,
    ).observe(ratio, site=site)
    return ratio


def record_bin_growth() -> None:
    """One on-device doubling of a solve's merged bin axis (the doubled
    re-run in models/solver.py ``_run_and_decode``): the estimated axis
    ran dry and growth stayed on the device instead of routing the
    remainder through the host loop."""
    with _STATS_LOCK:
        STATS["bin_growths"] += 1


def record_shard_overlap(seconds: float, registry=None) -> None:
    """Host tensorize wall time of one partitioned mesh solve that ran
    while earlier shards' programs were already in flight — the pipelined
    shard.tensorize-under-shard.block overlap, counted so the MULTICHIP
    rows can show the pipeline engaged rather than inferring it from
    span arithmetic."""
    seconds = max(float(seconds), 0.0)
    with _STATS_LOCK:
        STATS["shard_overlap_ms"] += seconds * 1000.0
    from karpenter_tpu_torch.operator import metrics as _m

    _resolve_registry(registry).counter(
        _m.SHARD_OVERLAP_SECONDS,
        "host shard-tensorize seconds hidden under in-flight shard solves "
        "(partitioned mesh pipeline)",
    ).inc(seconds)


def record_shard_repair(pods: int, registry=None) -> None:
    """Straddling pods the partitioned merge's bounded host repair pass
    re-packed (parallel/mesh.py _repair_merged)."""
    pods = max(int(pods), 0)
    if not pods:
        return
    with _STATS_LOCK:
        STATS["shard_repair_pods"] += pods
    from karpenter_tpu_torch.operator import metrics as _m

    _resolve_registry(registry).counter(
        _m.SHARD_REPAIR_PODS,
        "straddling pods re-packed by the partitioned mesh repair pass",
    ).inc(pods)


def record_shard_balance(ratio: float, registry=None) -> None:
    """Shard-balance quality of one partition plan: max/mean hybrid shard
    weight (parallel/mesh.py plan_shards). 1.0 is a perfectly balanced
    partition; the hybrid weight bounds it at ~2x without minimizing it,
    and this gauge is the surface the ROADMAP's balance lever reads."""
    ratio = max(float(ratio), 0.0)
    with _STATS_LOCK:
        STATS["shard_balance_ratio"] = ratio
    from karpenter_tpu_torch.operator import metrics as _m

    _resolve_registry(registry).gauge(
        _m.SHARD_BALANCE_RATIO,
        "max/mean shard weight of the most recent partitioned mesh plan",
    ).set(ratio)


def record_shard_fallback(reason: str, registry=None) -> None:
    """One abandonment of the partitioned mesh rung (repair bound
    exceeded, etc.) — the solve fell back to an exact slower path."""
    with _STATS_LOCK:
        STATS["shard_fallbacks"] += 1
    from karpenter_tpu_torch.operator import metrics as _m

    _resolve_registry(registry).counter(
        _m.SHARD_FALLBACKS,
        "partitioned mesh solves that fell back to an exact slower path",
    ).inc(reason=reason)


class SloTracker:
    """Rolling request-latency/outcome window with quantiles and an
    error-budget burn counter.

    ``observe`` records one request: the duration lands in the
    ``karpenter_solver_request_seconds{outcome}`` histogram, the rolling
    window's p50/p95/p99 refresh their gauges, and a request that
    violates the objective burns error budget. Violation = the outcome is
    a failure (``error``/``rejected`` — ``resync`` is a protocol
    renegotiation, not a failure), or the duration exceeds ``latency_slo``
    seconds when one is set. ``snapshot()`` is the ``/slo`` endpoint's
    JSON body.

    Multi-tenant surfaces: passing ``tenant=`` additionally maintains a
    per-tenant rolling window (quantile gauges and
    ``karpenter_solver_tenant_requests_total{slo,tenant,outcome}`` carry
    the tenant label) and the snapshot gains a ``tenants`` section — the
    per-tenant SLO plane rides the same tracker rather than a new
    one."""

    # outcomes that do NOT burn error budget: a resync demand is the delta
    # protocol renegotiating, not a failed request
    _OK_OUTCOMES = ("ok", "resync")
    # tenant sub-windows are bounded: tenant ids are client-supplied, and
    # a fleet with ephemeral tenant names must not grow tracker memory
    # without limit — the least-recently-observed tenant's window drops at
    # the cap (its already-emitted metric series remain on the registry;
    # operators with unbounded tenant churn should also bound scrape
    # cardinality upstream)
    _TENANT_CAP = 256

    def __init__(self, name: str, objective: float = 0.99,
                 latency_slo: float | None = None, window: int = 512):
        self.name = name
        self.objective = objective
        self.latency_slo = latency_slo
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=max(window, 16))
        self._count = 0
        self._errors = 0
        self._burned = 0
        # tenant -> {window, count, errors, burned} rolling sub-views
        self._tenants: dict = {}

    def observe(self, seconds: float, outcome: str = "ok", registry=None,
                tenant: str | None = None):
        violated = outcome not in self._OK_OUTCOMES or (
            self.latency_slo is not None and seconds > self.latency_slo
        )
        t_samples = None
        evicted = None
        with self._lock:
            self._window.append(float(seconds))
            self._count += 1
            if outcome not in self._OK_OUTCOMES:
                self._errors += 1
            if violated:
                self._burned += 1
            samples = sorted(self._window)
            if tenant is not None:
                tv = self._tenants.pop(tenant, None)
                if tv is None:
                    if len(self._tenants) >= self._TENANT_CAP:
                        # dict order is recency order (pop+reinsert below)
                        evicted = next(iter(self._tenants))
                        self._tenants.pop(evicted)
                    tv = {
                        "window": deque(maxlen=256), "count": 0,
                        "errors": 0, "burned": 0,
                    }
                self._tenants[tenant] = tv
                tv["window"].append(float(seconds))
                tv["count"] += 1
                if outcome not in self._OK_OUTCOMES:
                    tv["errors"] += 1
                if violated:
                    tv["burned"] += 1
                t_samples = sorted(tv["window"])
        from karpenter_tpu_torch.operator import metrics as _m

        reg = _resolve_registry(registry)
        if evicted is not None:
            # the LRU-dropped tenant's billing/quantile series retire with
            # its sub-window (obs/timeline.py drop_tenant) — the bounded-
            # cardinality stance extended to the metric registry
            from karpenter_tpu_torch.obs import timeline as _timeline

            _timeline.drop_tenant(evicted, slo=self.name, registry=reg)
        reg.histogram(
            _m.SOLVER_REQUEST_SECONDS,
            "solver-service request durations by outcome",
        ).observe(seconds, outcome=outcome)
        if violated:
            reg.counter(
                _m.SLO_BUDGET_BURN,
                "requests that violated the SLO objective (errors, or "
                "latency above the tracker's latency SLO)",
            ).inc(slo=self.name)
        q = reg.gauge(
            _m.SOLVER_REQUEST_QUANTILE,
            "rolling request-latency quantiles over the SLO window",
        )
        for label, v in self._quantiles(samples).items():
            q.set(v, slo=self.name, q=label)
        if tenant is not None:
            reg.counter(
                _m.SOLVER_TENANT_REQUESTS,
                "solver-service requests by tenant and outcome",
            ).inc(slo=self.name, tenant=tenant, outcome=outcome)
            for label, v in self._quantiles(t_samples).items():
                q.set(v, slo=self.name, tenant=tenant, q=label)

    def tenant_quantiles(self, tenant: str) -> dict:
        """Rolling {p50,p95,p99} (seconds) of one tenant's sub-window —
        the perf harness's per-tenant latency read."""
        with self._lock:
            tv = self._tenants.get(tenant)
            samples = sorted(tv["window"]) if tv is not None else []
        return self._quantiles(samples)

    @staticmethod
    def _quantiles(samples: list) -> dict:
        if not samples:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        n = len(samples)
        return {
            label: samples[min(int(frac * n), n - 1)]
            for label, frac in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))
        }

    def snapshot(self) -> dict:
        with self._lock:
            samples = sorted(self._window)
            count, errors, burned = self._count, self._errors, self._burned
            tenants = {
                t: (sorted(tv["window"]), tv["count"], tv["errors"],
                    tv["burned"])
                for t, tv in self._tenants.items()
            }
        qs = self._quantiles(samples)
        tenant_view = {}
        for t, (t_samples, t_count, t_errors, t_burned) in tenants.items():
            tq = self._quantiles(t_samples)
            tenant_view[t] = {
                "count": t_count,
                "errors": t_errors,
                "budget_burned": t_burned,
                "p50_ms": round(tq["p50"] * 1000.0, 3),
                "p95_ms": round(tq["p95"] * 1000.0, 3),
                "p99_ms": round(tq["p99"] * 1000.0, 3),
            }
        error_rate = errors / count if count else 0.0
        # budget burn: fraction of the window's allowed violations spent —
        # >1.0 means the objective is being missed
        allowed = max(count, 1) * max(1.0 - self.objective, 1e-9)
        return {
            "count": count,
            "errors": errors,
            "error_rate": round(error_rate, 6),
            "objective": self.objective,
            "latency_slo_ms": (
                round(self.latency_slo * 1000.0, 3)
                if self.latency_slo is not None else None
            ),
            "budget_burned": burned,
            "budget_burn_ratio": round(burned / allowed, 4),
            "window": len(samples),
            "p50_ms": round(qs["p50"] * 1000.0, 3),
            "p95_ms": round(qs["p95"] * 1000.0, 3),
            "p99_ms": round(qs["p99"] * 1000.0, 3),
            **({"tenants": tenant_view} if tenant_view else {}),
        }


_SLO_LOCK = threading.Lock()
_SLO: dict = {}


def slo_tracker(name: str, **kw) -> SloTracker:
    """Get-or-create the named tracker (constructor kwargs apply only on
    first creation)."""
    with _SLO_LOCK:
        t = _SLO.get(name)
        if t is None:
            t = _SLO[name] = SloTracker(name, **kw)
        return t


def slo_snapshot() -> dict:
    """The /slo endpoint body: every tracker's rolling view plus the
    compile ledger summary."""
    with _SLO_LOCK:
        trackers = list(_SLO.values())
    return {
        "slo": {t.name: t.snapshot() for t in trackers},
        "compile_ledger": LEDGER.snapshot(),
    }


def reset():
    """Test isolation: clear the ledger, the SLO trackers, and STATS."""
    LEDGER.clear()
    LEDGER.steady_after = _env_steady_after()
    with _SLO_LOCK:
        _SLO.clear()
    with _STATS_LOCK:
        STATS.update(
            cold_compiles=0, compile_ms=0.0, warm_dispatches=0,
            pad_dispatches=0, pad_cells_actual=0.0, pad_cells_padded=0.0,
            shard_overlap_ms=0.0, shard_repair_pods=0, shard_fallbacks=0,
            shard_balance_ratio=0.0, bin_growths=0, dispatch_seconds=0.0,
        )
