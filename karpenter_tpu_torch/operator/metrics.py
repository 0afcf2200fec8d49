"""In-process metrics: Prometheus-shaped counters/gauges/histograms.

Mirror of the reference's pkg/metrics (metrics.go:30-148, constants.go:65):
the same namespaced metric families (karpenter_*), a `measure()` timer that
plays the role of the reference's `metrics.Measure` closure helper, and a
text exposition dump compatible with the Prometheus format so an operator
can scrape or snapshot it. No client library dependency — the registry is
a couple of dicts guarded by a lock, cheap enough to sit on the solve path.

Readers (``value``/``count``/``sum``) and the per-family ``expose`` hold
the same registry lock the writers do: an unlocked read racing ``inc``
can observe a half-applied sweep (clear-then-set gauges, a histogram
whose bucket counts moved but whose ``_sum`` hasn't) — exposition must be
a consistent snapshot, not a torn one.

The port's copy of ``karpenter_tpu/operator/metrics.py`` (imports changed).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

NAMESPACE = "karpenter"

DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0,
)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help: str, registry: "Registry"):
        self.name = name
        self.help = help
        self._lock = registry._lock

    def _expose_header(self, kind: str) -> list:
        return [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {kind}"]


class Counter(_Metric):
    def __init__(self, name, help, registry):
        super().__init__(name, help, registry)
        self._values: dict = {}

    def inc(self, amount: float = 1.0, **labels):
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)

    def total(self) -> float:
        """Sum across every label combination — aggregate reads (e.g. "did
        ANY fallback happen", regardless of code/reason labels)."""
        with self._lock:
            return sum(self._values.values())

    def expose(self) -> list:
        out = self._expose_header("counter")
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge(_Metric):
    def __init__(self, name, help, registry):
        super().__init__(name, help, registry)
        self._values: dict = {}

    def set(self, value: float, **labels):
        with self._lock:
            self._values[_labels_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)

    def clear(self):
        """Exporters rebuild the full gauge family each sweep (the
        controllers/metrics/* pattern of delete-then-set)."""
        with self._lock:
            self._values.clear()

    def remove(self, **labels):
        """Delete ONE label combination — for exporters that reconcile a
        partial view (e.g. one pool's catalog) and must retire exactly
        the series they own without clearing the whole family."""
        with self._lock:
            self._values.pop(_labels_key(labels), None)

    def expose(self) -> list:
        out = self._expose_header("gauge")
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram(_Metric):
    def __init__(self, name, help, registry, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict = {}  # labels -> [per-bucket cumulative-ready counts]
        self._sum: dict = {}
        self._total: dict = {}

    def observe(self, value: float, **labels):
        key = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._total[key] = self._total.get(key, 0) + 1

    def remove(self, **labels):
        """Delete ONE label combination — Gauge.remove parity, so a
        bounded-cardinality owner (the fleet ledger's per-tenant billing,
        obs/timeline.py) can retire exactly the series of a tenant whose
        rolling sub-window LRU-dropped."""
        key = _labels_key(labels)
        with self._lock:
            self._counts.pop(key, None)
            self._sum.pop(key, None)
            self._total.pop(key, None)

    def count(self, **labels) -> int:
        with self._lock:
            return self._total.get(_labels_key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sum.get(_labels_key(labels), 0.0)

    def expose(self) -> list:
        out = self._expose_header("histogram")
        with self._lock:
            snapshot = [
                (key, list(self._counts[key]), self._sum[key], self._total[key])
                for key in sorted(self._total)
            ]
        for key, counts, total_sum, total in snapshot:
            for i, b in enumerate(self.buckets):
                bkey = key + (("le", str(b)),)
                out.append(f"{self.name}_bucket{_fmt_labels(bkey)} {counts[i]}")
            out.append(f"{self.name}_bucket{_fmt_labels(key + (('le', '+Inf'),))} {total}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {total_sum}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {total}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict = {}

    def _get_or_make(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, buckets=buckets)

    def expose(self) -> str:
        """Prometheus text exposition of every registered family."""
        lines = []
        with self._lock:
            for name in sorted(self._metrics):
                lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + "\n"

    @contextmanager
    def measure(self, histogram_name: str, **labels):
        """Timer context: the reference's metrics.Measure closure
        (pkg/metrics/constants.go:65)."""
        hist = self.histogram(histogram_name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            hist.observe(time.perf_counter() - t0, **labels)


# the default in-process registry, the controller-runtime-registry analog
REGISTRY = Registry()

# well-known family names (pkg/metrics/constants.go + per-package metrics.go)
SCHEDULING_DURATION = f"{NAMESPACE}_provisioner_scheduling_duration_seconds"
SCHEDULING_QUEUE_DEPTH = f"{NAMESPACE}_provisioner_scheduling_queue_depth"
IGNORED_PODS = f"{NAMESPACE}_provisioner_ignored_pod_count"
NODECLAIMS_CREATED = f"{NAMESPACE}_nodeclaims_created_total"
NODECLAIMS_TERMINATED = f"{NAMESPACE}_nodeclaims_terminated_total"
NODECLAIMS_LAUNCHED = f"{NAMESPACE}_nodeclaims_launched_total"
NODECLAIMS_REGISTERED = f"{NAMESPACE}_nodeclaims_registered_total"
NODECLAIMS_INITIALIZED = f"{NAMESPACE}_nodeclaims_initialized_total"
DISRUPTION_EVAL_DURATION = f"{NAMESPACE}_disruption_evaluation_duration_seconds"
DISRUPTION_ACTIONS = f"{NAMESPACE}_disruption_actions_performed_total"
DISRUPTION_ELIGIBLE_NODES = f"{NAMESPACE}_disruption_eligible_nodes"
DISRUPTION_PODS = f"{NAMESPACE}_disruption_pods_disrupted_total"
DISRUPTION_BUDGETS = f"{NAMESPACE}_disruption_allowed_disruptions"
CONSOLIDATION_TIMEOUTS = f"{NAMESPACE}_disruption_consolidation_timeouts_total"
DISRUPTION_PROBE_FAILURES = f"{NAMESPACE}_disruption_probe_failures_total"
DISRUPTION_SNAPSHOT_CACHE_HITS = (
    f"{NAMESPACE}_disruption_snapshot_cache_hits_total"
)
DISRUPTION_SNAPSHOT_CACHE_MISSES = (
    f"{NAMESPACE}_disruption_snapshot_cache_misses_total"
)
DISRUPTION_PROBE_BATCH_SIZE = f"{NAMESPACE}_disruption_probe_batch_size"
# confirming host simulations per consolidation method ("multi"/"single"):
# the batched confirm ladder targets ≤1 per MultiNode round — a climbing
# count means probe-vs-host disagreement (sequential fallbacks)
DISRUPTION_HOST_CONFIRMS = f"{NAMESPACE}_disruption_host_confirms_total"
DISRUPTION_CONFIRM_DURATION = (
    f"{NAMESPACE}_disruption_confirm_duration_seconds"
)
# negative node availabilities clamped during tensorization — mirrored from
# ops/tensorize.py (capacity-accounting bugs must surface, not vanish)
TENSORIZE_NEGATIVE_AVAIL = f"{NAMESPACE}_tensorize_negative_avail_total"
# pods each live solve routed to the host engine instead of the device
# path, by reason label (waves compiler inexpressibles, spec ineligibility,
# small-batch cutoff) — a grid regression shows up here as a reason spike
PROVISIONING_HOST_ROUTED = f"{NAMESPACE}_provisioning_host_routed_pods_total"
# spot resilience (deploy/README.md "Spot resilience"): interruption
# notices pulled from the cloud provider (outcome=marked|unknown-node),
# nodes drained proactively ahead of their notice deadline, notices whose
# deadline forced the degraded immediate-drain path, and the per-offering
# interruption-risk signal (labels instance_type/zone/capacity_type,
# known nonzero risks only — exported by cloudprovider/metrics.py)
INTERRUPTION_NOTICES = f"{NAMESPACE}_interruption_notices_total"
INTERRUPTION_PROACTIVE_DRAINS = (
    f"{NAMESPACE}_interruption_proactive_drains_total"
)
INTERRUPTION_DEADLINE_DEGRADATIONS = (
    f"{NAMESPACE}_interruption_deadline_degradations_total"
)
OFFERING_RISK = f"{NAMESPACE}_offering_risk"
# admission plane (karpenter_tpu_torch/admission): victim pods evicted by a
# confirmed preemption, and preemption ladder outcomes by outcome label
# (the per-rung mix also rides karpenter_decision_total{site="admission.*"})
ADMISSION_EVICTIONS = f"{NAMESPACE}_admission_preemption_evictions_total"
ADMISSION_PREEMPTIONS = f"{NAMESPACE}_admission_preemptions_total"
# counterfactual-rows-per-dispatch buckets (powers of two up to the probe's
# chunk cap) — durations make no sense for a size histogram
PROBE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
DISRUPTION_ABNORMAL_RUNS = f"{NAMESPACE}_disruption_abnormal_runs_total"
NODECLAIMS_DISRUPTED = f"{NAMESPACE}_nodeclaims_disrupted_total"
CLUSTER_STATE_SYNCED = f"{NAMESPACE}_cluster_state_synced"
CLOUDPROVIDER_DURATION = f"{NAMESPACE}_cloudprovider_duration_seconds"
CLOUDPROVIDER_ERRORS = f"{NAMESPACE}_cloudprovider_errors_total"
SOLVER_REMOTE_FALLBACKS = f"{NAMESPACE}_solver_remote_fallbacks_total"
PODS_STATE = f"{NAMESPACE}_pods_state"
PODS_STARTUP_DURATION = f"{NAMESPACE}_pods_startup_duration_seconds"
NODES_CREATED = f"{NAMESPACE}_nodes_created_total"
NODES_TERMINATED = f"{NAMESPACE}_nodes_terminated_total"
NODE_TERMINATION_DURATION = f"{NAMESPACE}_nodes_termination_duration_seconds"
NODECLAIM_TERMINATION_DURATION = (
    f"{NAMESPACE}_nodeclaims_termination_duration_seconds"
)
# device-plane telemetry (obs/devplane.py): the compile
# ledger (cold-compile events/wall time + resident executable families),
# pow-2 padding-waste fractions per dispatch site, and the solver-service
# SLO surfaces (request histogram, rolling quantile gauges, error-budget
# burn) — see deploy/README.md "Device-plane & SLO telemetry"
COMPILE_EVENTS = f"{NAMESPACE}_compile_events_total"
COMPILE_SECONDS = f"{NAMESPACE}_compile_seconds"
COMPILE_FAMILIES = f"{NAMESPACE}_compile_families_resident"
PAD_WASTE_RATIO = f"{NAMESPACE}_pad_waste_ratio"
# waste is a fraction in [0,1]; duration buckets make no sense for it
PAD_WASTE_BUCKETS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.625, 0.75,
                     0.875, 1.0)
# partitioned mesh solve (parallel/mesh.py): pipelined-tensorize overlap
# seconds, straddling pods re-packed by the bounded repair pass, and
# fallbacks out of the partitioned rung by reason
SHARD_OVERLAP_SECONDS = f"{NAMESPACE}_shard_tensorize_overlap_seconds_total"
SHARD_REPAIR_PODS = f"{NAMESPACE}_shard_repair_pods_total"
SHARD_FALLBACKS = f"{NAMESPACE}_shard_fallbacks_total"
SOLVER_REQUEST_SECONDS = f"{NAMESPACE}_solver_request_seconds"
SOLVER_REQUEST_QUANTILE = f"{NAMESPACE}_solver_request_quantile_seconds"
SLO_BUDGET_BURN = f"{NAMESPACE}_slo_error_budget_burn_total"
# multi-tenant solver fleet service (service/session.py + solver_service.py):
# per-tenant request counters on the SLO plane, session-cache efficacy with
# an LRU byte budget, streaming-delta resync accounting, the coalescer's
# batched-dispatch shape, admission rejections, transport retries, wire
# payload sizes, and the cross-tenant-bleed assertion hook
SOLVER_TENANT_REQUESTS = f"{NAMESPACE}_solver_tenant_requests_total"
SOLVER_SESSIONS = f"{NAMESPACE}_solver_sessions_active"
SOLVER_SESSION_CACHE_HITS = f"{NAMESPACE}_solver_session_cache_hits_total"
SOLVER_SESSION_CACHE_STORES = f"{NAMESPACE}_solver_session_cache_stores_total"
SOLVER_SESSION_CACHE_EVICTIONS = (
    f"{NAMESPACE}_solver_session_cache_evictions_total"
)
SOLVER_SESSION_CACHE_BYTES = f"{NAMESPACE}_solver_session_cache_bytes"
SOLVER_SESSION_RESYNCS = f"{NAMESPACE}_solver_session_resyncs_total"
SOLVER_COALESCED = f"{NAMESPACE}_solver_coalesced_requests_total"
SOLVER_COALESCE_BATCH = f"{NAMESPACE}_solver_coalesce_batch_size"
# requests folded per dispatch window — powers of two like the probe's
SOLVER_COALESCE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
SOLVER_ADMISSION_REJECTS = f"{NAMESPACE}_solver_admission_rejects_total"
SOLVER_REMOTE_RETRIES = f"{NAMESPACE}_solver_remote_retries_total"
SOLVER_REQUEST_BYTES = f"{NAMESPACE}_solver_request_bytes"
# wire payload sizes: bytes, not seconds
SOLVER_REQUEST_BYTES_BUCKETS = (
    1e3, 1e4, 1e5, 1e6, 5e6, 1e7, 5e7, 1e8, 2.56e8,
)
SOLVER_BLEED_CHECKS = f"{NAMESPACE}_solver_bleed_checks_total"
# session-GC sweeps on the solver fleet service (service/session.py
# SessionRegistry.sweep): each sweep reaps expired sessions and releases
# their bundle bytes from the LRU budget without a client access
SOLVER_SESSION_SWEEPS = f"{NAMESPACE}_solver_session_sweeps_total"
# decision plane (obs/decisions.py): one ladder verdict per
# site invocation (labels site/rung/reason, reasons drawn from the closed
# per-site enums so cardinality is bounded), the per-solve node-count
# overhead over the solver's pods-cap floor, and per-multichip-solve shard
# balance (max/mean hybrid shard weight, parallel/mesh.py plan_shards) —
# see deploy/README.md "Decision plane"
DECISION_TOTAL = f"{NAMESPACE}_decision_total"
SOLVE_OVERHEAD_RATIO = f"{NAMESPACE}_solve_overhead_ratio"
SHARD_BALANCE_RATIO = f"{NAMESPACE}_shard_balance_ratio"
# span-derived families fed by the reconcile flight recorder
# (obs/): per-span self time, round durations, anomaly
# trigger counts, and trace files written
TRACE_SPAN_SECONDS = f"{NAMESPACE}_trace_span_self_seconds"
TRACE_ROUND_SECONDS = f"{NAMESPACE}_trace_round_duration_seconds"
TRACE_ANOMALIES = f"{NAMESPACE}_trace_anomalies_total"
TRACE_DUMPS = f"{NAMESPACE}_trace_dumps_total"
# replay capsules (the JAX package's karpenter_tpu/obs/capsule.py): capsule files written
# next to the Chrome dumps (labels seam + why = anomaly|forced), and
# captures skipped by the KARPENTER_CAPSULE_BYTES size budget
CAPSULE_WRITES = f"{NAMESPACE}_capsule_writes_total"
CAPSULE_SKIPPED = f"{NAMESPACE}_capsule_skipped_total"
# fleet ledger (obs/timeline.py): effective-price dollars
# integrated over node lifetimes, predicted vs realized savings rates of
# reconciled disruption commands, per-tenant device-time billing (the
# histogram's tenant series retire via Histogram.remove when the tenant's
# SLO sub-window LRU-drops), and committed lifecycle-timeline events by
# kind — see deploy/README.md "Fleet ledger"
FLEET_COST_REALIZED = f"{NAMESPACE}_fleet_cost_realized_total"
FLEET_SAVINGS_PREDICTED = f"{NAMESPACE}_fleet_savings_predicted_total"
FLEET_SAVINGS_REALIZED = f"{NAMESPACE}_fleet_savings_realized_total"
TENANT_DEVICE_SECONDS = f"{NAMESPACE}_tenant_device_seconds_total"
TENANT_DISPATCH_SECONDS = f"{NAMESPACE}_tenant_dispatch_seconds"
TIMELINE_EVENTS = f"{NAMESPACE}_timeline_events_total"
NODES_ALLOCATABLE = f"{NAMESPACE}_nodes_allocatable"
NODES_TOTAL = f"{NAMESPACE}_nodes_count"
NODEPOOL_USAGE = f"{NAMESPACE}_nodepool_usage"
NODEPOOL_LIMIT = f"{NAMESPACE}_nodepool_limit"
