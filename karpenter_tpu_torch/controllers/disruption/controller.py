"""The disruption singleton controller.

Mirror of the reference's pkg/controllers/disruption/controller.go: a 10 s
polling loop (:65) that — after the cluster-state sync gate (:116) and
idempotent cleanup of taints left by a dead process (:121-128) — tries each
method in order, executing the first command produced (:130-141). Commands
from consolidation methods are held for a validation TTL (15 s,
consolidation.go:44) and revalidated against fresh state before execution
(validation.go:55-212); our synchronous runtime models the reference's
blocking TTL wait as a pending-command slot re-checked on later polls.

The port's copy of ``karpenter_tpu/controllers/disruption/controller.py``
(imports changed; ``TorchSolver`` where the JAX package tests for
``TPUSolver``). ``InterruptionDrain`` runs first in the ring and the
cloud provider's interruption notices are pulled on every poll. Each
round is a ``disrupt`` flight-recorder round; ``_observe_fleet_cost``
advances the fleet ledger's realized-cost integral, and an executed
command opens its ledger entry with the predicted savings its drain
events carry (obs/timeline.py). A snapshot prewarm that hits a device
fault propagates, as the probes do (``ops.cuda_kernels.DEVICE_FAULTS``);
any other failure falls back and is counted in
``DISRUPTION_PROBE_FAILURES`` (method ``prewarm``).
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api.nodepool import REASON_EMPTY
from karpenter_tpu_torch.controllers.disruption.helpers import (
    build_disruption_budgets,
    get_candidates,
    simulate_scheduling,
)
from karpenter_tpu_torch.controllers.disruption.methods import (
    Drift,
    Emptiness,
    EmptyNodeConsolidation,
    GlobalConsolidation,
    InterruptionDrain,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_tpu_torch.controllers.disruption.queue import (
    OrchestrationQueue,
    add_disruption_taint,
)

POLL_PERIOD = 10.0  # controller.go:65
VALIDATION_TTL = 15.0  # consolidation.go:44
ABNORMAL_RUN_GAP = 15 * 60.0  # logAbnormalRuns threshold (controller.go:274-283)


class DisruptionContext:
    def __init__(self, provisioner, cluster, store, clock, options=None,
                 registry=None, cloud=None):
        from karpenter_tpu_torch.operator import metrics as _m
        from karpenter_tpu_torch.ops.consolidate import SnapshotCache

        self.provisioner = provisioner
        self.cluster = cluster
        self.store = store
        self.clock = clock
        self.options = options or {}
        self.registry = registry or _m.REGISTRY
        # the cloud provider seam: InterruptionDrain rebuilds candidates
        # for noticed nodes the voluntary-disruption filters excluded
        self.cloud = cloud
        # one tensorization per cluster-state generation, shared by every
        # consolidation probe and confirming simulation in a round
        # (ops/consolidate.py documents the invalidation contract)
        self.snapshot_cache = SnapshotCache()
        # the round's joint-dispatch seed (ops/consolidate.py JointSeed):
        # published by GlobalConsolidation, consumed by the MultiNode/
        # SingleNode probes of the SAME generation so one state bump pays
        # one device dispatch, not three (the short-circuit)
        self.joint_seed = None
        # per-(generation, pool) memo of the shared candidate order
        # (methods._candidate_order): all three consolidation methods
        # sort the same objects within one round — pay it once
        self.order_memo = None


class DisruptionController:
    def __init__(
        self,
        store,
        cluster,
        cloud,
        provisioner,
        clock=None,
        recorder=None,
        options=None,
        poll_period: float = POLL_PERIOD,
        validation_ttl: float = VALIDATION_TTL,
        registry=None,
        log=None,
    ):
        from karpenter_tpu_torch.operator import metrics as _m
        from karpenter_tpu_torch.operator.logging import NOP
        from karpenter_tpu_torch.utils.clock import Clock

        self.log = log if log is not None else NOP
        self.registry = registry or _m.REGISTRY
        self.store = store
        self.cluster = cluster
        self.cloud = cloud
        self.provisioner = provisioner
        self.clock = clock or Clock()
        self.recorder = recorder
        self.poll_period = poll_period
        self.validation_ttl = validation_ttl
        self.ctx = DisruptionContext(
            provisioner, cluster, store, self.clock, options,
            registry=self.registry, cloud=cloud,
        )
        self.queue = OrchestrationQueue(store, cluster, self.clock, recorder)
        self.methods = [
            # interruption FIRST: a reclaim deadline outranks every
            # voluntary method — the node is leaving whether we act or
            # not, and acting early is the whole resilience story
            InterruptionDrain(self.ctx),
            Drift(self.ctx),
            Emptiness(self.ctx),
            EmptyNodeConsolidation(self.ctx),
            # the joint device-solved retirement runs FIRST among the
            # underutilized methods: when it ships, the per-candidate
            # ladder below never runs (first success wins); every fallback
            # cause hands the round to the ladder, its oracle duty
            # (deploy/README.md "Global consolidation")
            GlobalConsolidation(self.ctx),
            MultiNodeConsolidation(self.ctx),
            SingleNodeConsolidation(self.ctx),
        ]
        self._last_run: float = -1e18
        self._pending = None  # (command, method, computed_at)
        # per-nodepool instance-type catalog memo for candidate discovery
        # (helpers.get_candidates): cleared on nodepool events, shared by
        # compute and validate so repeated rounds stop re-listing the
        # cloud provider. Offering mutations stay visible — the catalog
        # objects are shared by identity.
        self._catalog_cache: dict = {}
        # fence from the last consolidation round that found nothing: while
        # cluster state is unchanged, re-searching is pointless
        # (consolidation.go isConsolidated)
        self._noop_fence = None

    def on_event(self, event):
        if event.kind == "nodepools":
            # a nodepool change can change which instance types it may use
            self._catalog_cache.clear()

    def poll(self) -> bool:
        progressed = self.queue.poll()
        # interruption notices are pulled on EVERY poll (not only on the
        # 10 s round cadence): a two-minute warning must reach cluster
        # state the moment it exists — the pull is one drained list
        self._pull_interruption_notices()
        now = self.clock.now()
        if now - self._last_run < self.poll_period:
            return progressed
        self._log_abnormal_run(now)
        self._last_run = now
        self._observe_fleet_cost(now)
        if not self.cluster.synced():
            return progressed
        # one trace per disruption round: the method ladder, every probe
        # dispatch, and every confirming simulation nest under it, so an
        # anomalous round (probe fallback, >1 MultiNode confirm, snapshot
        # rebuild) dumps with its full causal span tree
        with obs.round_trace("disrupt", registry=self.registry):
            with obs.span("disrupt.taint_cleanup"):
                self._cleanup_orphan_taints()
            if self._pending is not None:
                return self._handle_pending() or progressed
            return self._compute_round() or progressed

    # -- interruption notices (spot resilience) --------------------------
    def _pull_interruption_notices(self):
        """Drain the cloud provider's interruption feed onto cluster
        state: each notice marks its StateNode with the reclaim deadline
        (``Cluster.note_interruption`` — a node-scoped journal entry, so
        the cached disruption snapshot delta-advances), lands a store
        event through the recorder, and counts on
        ``karpenter_interruption_notices_total{outcome}``."""
        from karpenter_tpu_torch.operator import metrics as m

        fn = getattr(self.cloud, "interruption_notices", None)
        if fn is None:
            return
        try:
            notices = fn()
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "interruption-notice pull failed; retrying next poll",
                exc_info=True)
            return
        if not notices:
            return
        counter = self.registry.counter(
            m.INTERRUPTION_NOTICES,
            "spot interruption notices pulled from the cloud provider")
        for n in notices:
            marked = self.cluster.note_interruption(n.provider_id,
                                                    n.deadline)
            counter.inc(outcome="marked" if marked else "unknown-node")
            if marked and self.recorder is not None:
                sn = self.cluster.node_for(n.provider_id)
                self.recorder.publish(
                    "SpotInterruptionNotice",
                    f"capacity behind {sn.name if sn else n.provider_id} "
                    f"will be reclaimed at {n.deadline:.0f}",
                )

    # -- realized-cost observation (fleet ledger) ------------------------
    def _observe_fleet_cost(self, now: float):
        """Advance the fleet ledger's realized-cost integral once per
        disruption round cadence (piecewise-constant between rounds): one
        CatalogView per sweep resolves every store node's offering, the
        integral accrues into ``karpenter_fleet_cost_realized_total``,
        and exposure-hours feed the observed interruption-rate
        denominators (obs/timeline.py)."""
        from karpenter_tpu_torch.cloudprovider.types import CatalogView
        from karpenter_tpu_torch.obs import timeline

        view = CatalogView(self.store.list("nodepools"), self.cloud)
        timeline.observe_fleet(self.store.list("nodes"), view, now,
                               registry=self.registry)

    # -- watchdog (logAbnormalRuns, controller.go:274-283) ---------------
    def _log_abnormal_run(self, now: float):
        """Flag pathological gaps between disruption-loop runs — a method
        that silently hangs (unbounded simulation, stuck cloud call) shows
        up here long before anything else notices."""
        from karpenter_tpu_torch.operator import metrics as m

        if self._last_run <= -1e17:  # first run ever
            return
        gap = now - self._last_run
        if gap < ABNORMAL_RUN_GAP:
            return
        self.registry.counter(
            m.DISRUPTION_ABNORMAL_RUNS, "disruption loop gaps exceeding 15 min"
        ).inc()
        if self.recorder is not None:
            self.recorder.publish(
                "AbnormalDisruptionRun",
                f"disruption loop ran {gap:.0f}s after the previous run",
            )

    # -- taint hygiene (controller.go:121-128) ---------------------------
    def _cleanup_orphan_taints(self):
        from karpenter_tpu_torch.api import labels as wk

        queued = {
            c.provider_id for cmd in self.queue.commands for c in cmd.candidates
        }
        for node in self.store.list("nodes"):
            if not any(t.key == wk.DISRUPTION_TAINT_KEY for t in node.taints):
                continue
            sn = self.cluster.node_by_name(node.name)
            pid = sn.provider_id if sn is not None else None
            if pid not in queued and node.metadata.deletion_timestamp is None:
                from karpenter_tpu_torch.controllers.disruption.queue import (
                    remove_disruption_taint,
                )

                remove_disruption_taint(self.store, node)

    # -- the method ladder (controller.go:130-141) -----------------------
    def _compute_round(self) -> bool:
        from karpenter_tpu_torch.operator import metrics as m

        with obs.span("disrupt.candidates"):
            candidates = get_candidates(
                self.cluster, self.store, self.cloud, self.clock,
                queue=self.queue, catalog_cache=self._catalog_cache,
            )
        self.registry.gauge(m.DISRUPTION_ELIGIBLE_NODES, "disruptable candidates").set(
            len(candidates))
        with obs.span("disrupt.budgets"):
            budgets = build_disruption_budgets(
                self.cluster, self.store, self.clock)
        # allowed-disruptions gauge per (nodepool, reason), refreshed every
        # round — including candidate-free ones, so closed budget windows
        # and deleted pools never serve stale values
        # (disruption/helpers.go:242's budget gauge)
        bg = self.registry.gauge(m.DISRUPTION_BUDGETS, "allowed disruptions")
        bg.clear()
        for pool, by_reason in budgets.items():
            for reason, allowed in by_reason.items():
                bg.set(allowed, nodepool=pool, reason=reason)
        if not candidates and not self.cluster.interruptions_pending():
            # noticed nodes must reach InterruptionDrain even when every
            # node fails the VOLUNTARY-disruption filters (do-not-disrupt,
            # PDB) — the reclaim doesn't care about those
            obs.discard_round()  # idle tick: nothing disruptable
            return False
        fence = self.cluster.consolidation_state()
        ran_search = False
        bundle_warmed = False
        for method in self.methods:
            if method.is_consolidation and fence == self._noop_fence:
                continue  # nothing moved since the last fruitless search
            ran_search = ran_search or method.is_consolidation
            if getattr(method, "uses_bundle", False) and not bundle_warmed:
                # the round's shared snapshot belongs to the ROUND, not to
                # whichever consolidation method happens to run first:
                # acquire (build or delta-advance) it once here so the
                # joint row's formulate_ms measures formulation, and the
                # tensorization cost is attributable as bundle_ms
                bundle_warmed = True
                self._prewarm_bundle(candidates)
            with obs.span(f"method.{type(method).__name__}"), \
                    self.registry.measure(
                        m.DISRUPTION_EVAL_DURATION,
                        method=type(method).__name__):
                cmd = method.compute_command(list(candidates), budgets)
            if cmd is None or not cmd.candidates:
                if getattr(method, "fence_round", False):
                    # the joint dispatch PROVED round-wide no-retirement
                    # (deploy/README.md "Global consolidation"): the
                    # remaining probes could only re-pay dispatches to
                    # learn nothing — close the consolidation round
                    break
                continue
            if method.needs_validation:
                self._pending = (cmd, method, self.clock.now())
                return True
            return self._execute(cmd, method)
        self._noop_fence = fence
        if not ran_search:
            # candidates exist but every consolidation search sat behind
            # the noop fence and the cheap filters (Drift/Emptiness) found
            # nothing — this tick carries no story; recording it every
            # poll_period would churn the one interesting round out of
            # the flight-recorder ring
            obs.discard_round()
        return False

    def _prewarm_bundle(self, candidates):
        """Acquire the round's shared DisruptionSnapshot before the first
        bundle-consuming method runs. This hoists the tensorization
        (build or delta-advance) out of the joint ladder's formulate
        window — the bundle serves Global/MultiNode/SingleNode AND every
        confirming simulation of the round, so its cost is round
        orchestration, reported as ``GLOBAL_STATS["bundle_ms"]``. A failed
        build is not fatal: methods re-attempt on demand and fall back to
        their sequential rungs as before, and the failure is counted —
        unless it is a device fault, which propagates."""
        import time as _time

        from karpenter_tpu_torch.controllers.disruption.methods import (
            _consolidatable,
            _probe_failure,
        )
        from karpenter_tpu_torch.models.solver import TorchSolver
        from karpenter_tpu_torch.ops import consolidate as cons
        from karpenter_tpu_torch.ops.cuda_kernels import DEVICE_FAULTS

        if not isinstance(getattr(self.provisioner, "solver", None),
                          TorchSolver):
            return
        pool = _consolidatable(candidates)
        if len(pool) < 2:
            return
        t0 = _time.perf_counter()
        with obs.span("disrupt.bundle", kind="cache",
                      candidates=len(pool)):
            try:
                self.ctx.snapshot_cache.get(
                    self.provisioner, self.cluster, self.store, pool,
                    registry=self.registry)
            except DEVICE_FAULTS:
                raise
            except Exception:
                import logging

                _probe_failure(self.ctx, "prewarm")
                logging.getLogger(__name__).warning(
                    "snapshot prewarm failed; methods build on demand",
                    exc_info=True)
        cons.GLOBAL_STATS["bundle_ms"] += (
            _time.perf_counter() - t0) * 1000.0

    # -- validation TTL (validation.go:55-212) ---------------------------
    def _handle_pending(self) -> bool:
        cmd, method, computed_at = self._pending
        if self.clock.now() - computed_at < self.validation_ttl:
            obs.discard_round()  # idle tick: waiting out the TTL
            return False  # still inside the TTL window
        self._pending = None
        with obs.span("disrupt.validate", method=type(method).__name__):
            ok = self._validate(cmd, method)
        if not ok:
            return True  # dropped; next round recomputes
        return self._execute(cmd, method)

    def _validate(self, cmd, method) -> bool:
        """Re-check the command against fresh state (validation.go:67)."""
        budgets = build_disruption_budgets(self.cluster, self.store, self.clock)
        fresh = {
            c.provider_id: c
            for c in get_candidates(
                self.cluster, self.store, self.cloud, self.clock, queue=self.queue,
                catalog_cache=self._catalog_cache,
            )
        }
        spent: dict = {}
        for c in cmd.candidates:
            fc = fresh.get(c.provider_id)
            if fc is None:
                return False  # candidate vanished or became non-disruptable
            pool = fc.node_pool.name
            spent[pool] = spent.get(pool, 0) + 1
            if spent[pool] > budgets.get(pool, {}).get(method.reason, 0):
                return False
            if method.reason == REASON_EMPTY and fc.reschedulable_pods:
                return False  # no longer empty
        if cmd.replacements:
            # re-simulate: the fresh simulation must still produce no more
            # claims than the command launches, and every instance type the
            # command would launch must still be among the types the fresh
            # simulation allows — a cheaper type that vanished (ICE'd,
            # price change) during the validation TTL invalidates the
            # command (validation.go:186: command types ⊆ fresh-sim types)
            # refresh FIRST: a successful delta-advance makes the bundle
            # generation-current, so inputs_for then serves the cached
            # solver inputs instead of a redundant re-assembly. After
            # _execute bumped the state, either path reflects every mark
            # the execute applied (delta-advanced or declined → rebuilt).
            bundle = self.ctx.snapshot_cache.refresh(
                self.provisioner, self.cluster, self.store,
                registry=self.registry,
            )
            sim = simulate_scheduling(
                self.provisioner, self.cluster, self.store, list(cmd.candidates),
                inputs=self.ctx.snapshot_cache.inputs_for(self.cluster),
                bundle=bundle,
            )
            if not sim.all_pods_scheduled() or len(sim.new_claims) > len(cmd.replacements):
                return False
            fresh_types = {
                it.name for claim in sim.new_claims for it in claim.instance_types
            }
            for claim in cmd.replacements:
                claim.instance_types = [
                    it for it in claim.instance_types if it.name in fresh_types
                ]
                if not claim.instance_types:
                    return False
        return True

    # -- execution (controller.go executeCommand:188) --------------------
    def _execute(self, cmd, method=None) -> bool:
        with obs.span("disrupt.execute", action=cmd.action, reason=cmd.reason):
            return self._execute_inner(cmd, method)

    def _execute_inner(self, cmd, method=None) -> bool:
        # 1. taint candidates so nothing schedules onto them (:196)
        for c in cmd.candidates:
            node = self.store.try_get("nodes", c.name)
            if node is not None:
                add_disruption_taint(self.store, node)
        # 2. launch replacements (:203)
        for claim in cmd.replacements:
            nc = claim.to_node_claim()
            self.store.create("nodeclaims", nc)
            cmd.replacement_names.append(nc.name)
        # 2b. open the command's fleet-ledger entry: predicted savings at
        # execution time, the cause chain every launch/drain event will
        # carry, and the pending claim/node sets whose completion
        # reconciles predicted vs realized (obs/timeline.py)
        from karpenter_tpu_torch.controllers.disruption.methods import (
            candidate_prices,
            predicted_command_savings,
        )
        from karpenter_tpu_torch.obs import timeline

        cmd.predicted_savings = predicted_command_savings(cmd)
        cause = {
            "site": getattr(method, "decision_site", "") or "",
            "rung": getattr(method, "last_rung", "") or "",
            "reason": cmd.reason,
        }
        cause["command"] = timeline.begin_command(
            site=cause["site"], rung=cause["rung"], reason=cmd.reason,
            predicted=cmd.predicted_savings,
            retired_rate=candidate_prices(cmd.candidates),
            claims=cmd.replacement_names,
            nodes=[c.name for c in cmd.candidates],
            registry=self.registry,
        )
        for name in cmd.replacement_names:
            timeline.pend_cause(name, cause)
        for c in cmd.candidates:
            timeline.record_event("drain", c.name, cause=cause,
                                  pods=len(c.reschedulable_pods))
        # 3. fence the state (:223)
        self.cluster.mark_for_deletion(*[c.provider_id for c in cmd.candidates])
        # 4. orchestrate deletion (:225)
        self.queue.add(cmd)
        from karpenter_tpu_torch.operator import metrics as m

        self.log.info(
            "disrupting nodes",
            reason=cmd.reason,
            action=cmd.action,
            nodes=",".join(c.name for c in cmd.candidates),
            replacements=len(cmd.replacements),
        )
        self.registry.counter(m.DISRUPTION_ACTIONS, "disruption commands executed").inc(
            action=cmd.action, reason=cmd.reason)
        self.registry.counter(m.DISRUPTION_PODS, "pods displaced by disruption").inc(
            sum(len(c.reschedulable_pods) for c in cmd.candidates), reason=cmd.reason)
        if self.recorder is not None:
            self.recorder.publish(
                "DisruptionLaunching",
                f"{cmd.reason}: {cmd.action} {[c.name for c in cmd.candidates]}",
            )
        return True
