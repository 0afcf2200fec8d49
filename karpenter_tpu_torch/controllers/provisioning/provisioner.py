"""Provisioner: the L4 singleton controller.

Mirror of the reference's pkg/controllers/provisioning/provisioner.go:
trigger on unschedulable pods (controller.go:52-66), debounce via the
batcher, snapshot cluster state, build the scheduler inputs (NewScheduler
:219-314 — ready nodepools by weight, per-pool instance types, the topology
domain universe :264-296, daemonset overhead), Solve, truncate instance
types (:363), then create NodeClaims and nominate the pods (:149-160).

The port's copy of ``karpenter_tpu/controllers/provisioning/
provisioner.py`` (imports changed). Its solver defaults to
``TorchSolver()``, which runs on CUDA and raises without a card. A live
batch carrying an admission marker (a pod priority or class, a gang
annotation, a non-zero global-default PriorityClass) goes through the
port's admission plane (``karpenter_tpu_torch.admission``), as in the
JAX package. Each live solve is a ``provision`` flight-recorder round
with the JAX package's spans, and a batch that sends pods to the host
engine for any but the calibrated reasons marks it ``host-routed``.
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.offering_table import STATS as truncate_stats
from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher
from karpenter_tpu_torch.models import ClaimTemplate
from karpenter_tpu_torch.models.topology import Topology
from karpenter_tpu_torch.scheduling import daemon_schedulable
from karpenter_tpu_torch.utils import pod as pod_util
from karpenter_tpu_torch.utils import resources as resutil


class ClusterStateView:
    """Topology's window onto bound pods, served from the state plane —
    no per-solve full-store rescans: bindings and the anti-affinity index
    are maintained incrementally by Cluster (state/cluster.py)."""

    def __init__(self, cluster, store):
        self.cluster = cluster
        self.store = store

    def pods_matching(self, namespaces, selector):
        for sn in self.cluster.state_nodes():
            labels = sn.labels()
            for pod in sn.pods.values():
                if pod.namespace not in namespaces:
                    continue
                if selector is not None and not selector.matches(pod.metadata.labels):
                    continue
                yield pod, labels

    def pods_with_anti_affinity(self):
        yield from self.cluster.pods_with_anti_affinity()

    def namespaces_matching(self, selector):
        return [
            ns.metadata.name
            for ns in self.store.list("namespaces")
            if selector.matches(ns.metadata.labels)
        ]


class StoreClusterView:
    """Adapter giving the topology engine visibility into bound pods
    (fallback when no state plane is wired, e.g. bare-solver use)."""

    def __init__(self, store):
        self.store = store
        self._node_labels = None

    def _labels_for(self, node_name):
        if self._node_labels is None:
            self._node_labels = {n.name: n.labels for n in self.store.list("nodes")}
        return self._node_labels.get(node_name, {})

    def pods_matching(self, namespaces, selector):
        for pod in self.store.list("pods"):
            if pod.namespace not in namespaces:
                continue
            if selector is not None and not selector.matches(pod.metadata.labels):
                continue
            yield pod, self._labels_for(pod.node_name)

    def pods_with_anti_affinity(self):
        for pod in self.store.list("pods"):
            if not pod.node_name:
                continue
            if (
                pod.affinity
                and pod.affinity.pod_anti_affinity
                and pod.affinity.pod_anti_affinity.required
            ):
                yield pod, self._labels_for(pod.node_name)

    def namespaces_matching(self, selector):
        return [
            ns.metadata.name
            for ns in self.store.list("namespaces")
            if selector.matches(ns.metadata.labels)
        ]


def collect_domains(domains: dict, template, instance_types):
    """Topology domain universe: values from instance-type requirements
    compatible with the nodepool (provisioner.go:264-296). Shared by the
    provisioner and the perf harness (which must assemble the same scheduler
    inputs the product path does)."""
    np_reqs = template.requirements
    for key, req in np_reqs.items():
        if not req.complement:
            domains.setdefault(key, set()).update(req.values)
    for it in instance_types:
        if it.requirements.intersects(np_reqs) is not None:
            continue
        for key, req in it.requirements.items():
            if req.complement:
                continue
            allowed = np_reqs.get_req(key)
            vals = {v for v in req.values if allowed.has(v)}
            if vals:
                domains.setdefault(key, set()).update(vals)


def nodepool_ready(np) -> bool:
    conds = getattr(np.status, "conditions", None) or []
    for c in conds:
        ctype = c.type if hasattr(c, "type") else c.get("type")
        status = c.status if hasattr(c, "status") else c.get("status")
        if ctype == "Ready":
            return status == "True"
    return True


class Provisioner:
    def __init__(self, store, cloud, solver=None, clock=None, batcher=None,
                 recorder=None, cluster=None, registry=None, log=None):
        from karpenter_tpu_torch.operator import metrics as m
        from karpenter_tpu_torch.operator.logging import NOP
        from karpenter_tpu_torch.utils.clock import Clock
        from karpenter_tpu_torch.utils.pretty import ChangeMonitor

        self.log = log if log is not None else NOP
        self.store = store
        self.cloud = cloud
        self.clock = clock or Clock()
        self.registry = registry or m.REGISTRY
        if solver is None:
            from karpenter_tpu_torch.models.solver import make_solver

            solver = make_solver()
        self.solver = solver
        # production default: the reference's 1s idle / 10s max debounce
        # window (options.go:96-97); test environments inject a 0/0 batcher
        self.batcher = batcher or Batcher(self.clock)
        self.recorder = recorder
        self._change_monitor = ChangeMonitor(clock=self.clock)
        self.cluster = cluster  # state plane; optional
        self._admission = None  # admission plane (priority/gang), lazy
        # unschedulable-pod retry clock (see _maybe_retry_pending)
        self._pending_retry_at: float = -1e18

    # -- triggering (provisioning/controller.go:52-107) ------------------
    def on_event(self, event):
        if event.kind == "pods":
            pod = event.obj
            if event.type != "Deleted" and pod_util.is_provisionable(pod):
                self.batcher.trigger()
        elif event.kind == "nodes" and event.type == "Modified":
            if event.obj.metadata.deletion_timestamp is not None:
                self.batcher.trigger()
        elif event.kind == "nodeclaims" and event.type == "Deleted":
            # a reaped UNREGISTERED claim (liveness TTL, insufficient-
            # capacity rollback) strands any pod nominated onto capacity
            # that will now never materialize: re-arm the batcher so the
            # next round re-solves those pods. REGISTERED claims are
            # exempt: their node's drain path owns the pods (evict →
            # recreate → bind), and re-triggering on every consolidation-
            # wave claim deletion would re-solve the whole displaced set
            # the binder is about to place.
            from karpenter_tpu_torch.api.nodeclaim import COND_REGISTERED

            if not event.obj.is_true(COND_REGISTERED):
                self.batcher.trigger()

    def trigger(self):
        self.batcher.trigger()

    # how often unschedulable pending pods are re-examined without any
    # triggering event — the kube-scheduler's unschedulable-queue retry
    # (and the reference provisioner's periodic singleton reconcile)
    # compressed to the hermetic runtime
    PENDING_RETRY_PERIOD = 10.0

    def _maybe_retry_pending(self) -> bool:
        """Re-arm the batcher for unschedulable pending pods on a slow
        clock, with no triggering event required: capacity can return
        WITHOUT one — an in-place offering flip, a reaped unregistered
        claim, a PDB releasing — and a purely event-driven batcher would
        strand those pods forever. At most one pod-list scan per
        PENDING_RETRY_PERIOD of clock, so idle rounds between clock steps
        stay free."""
        now = self.clock.now()
        if now - self._pending_retry_at < self.PENDING_RETRY_PERIOD:
            return False
        self._pending_retry_at = now
        if any(pod_util.is_provisionable(p)
               for p in self.store.list("pods")):
            self.batcher.trigger()
            return True
        return False

    @property
    def pending_trigger(self) -> bool:
        return self.batcher.triggered and self.batcher.ready()

    # -- the solve round (provisioner.go Schedule:316) -------------------
    def reconcile(self) -> bool:
        if not self.batcher.triggered and not self._maybe_retry_pending():
            return False
        if not self.batcher.ready():
            return False
        self.batcher.reset()
        from karpenter_tpu_torch.operator import metrics as m

        if self.cluster is not None:
            synced = self.cluster.synced()
            self.registry.gauge(
                m.CLUSTER_STATE_SYNCED, "cluster state mirror in sync"
            ).set(1.0 if synced else 0.0)
            if not synced:
                self.batcher.trigger()  # retry next round
                return False
        # one trace per solve round: the flight recorder keeps the span
        # tree and dumps it if the round trips an anomaly (host-routed
        # pods being the provisioning trigger)
        with obs.round_trace("provision", registry=self.registry):
            with self.registry.measure(m.SCHEDULING_DURATION):
                results = self.schedule()
            if results is None:
                return False
            with obs.span("provision.create"):
                return self.create_node_claims(results)

    def pending_pods(self) -> list:
        """Provisionable pods, excluding ones nominated onto capacity that
        is still materializing (the reference's cluster-state nomination
        serves this role, state/cluster.go Nominate)."""
        out = []
        for p in self.store.list("pods"):
            if not pod_util.is_provisionable(p):
                continue
            if p.nominated_node_name:
                nominated_alive = self.store.try_get(
                    "nodes", p.nominated_node_name
                ) is not None or any(
                    nc.name == p.nominated_node_name
                    for nc in self.store.list("nodeclaims")
                )
                if nominated_alive:
                    continue  # capacity is materializing; the binder lands it
                p.nominated_node_name = ""  # stale nomination: re-provision
            out.append(p)
        return out

    def schedule(self, pods=None, state_nodes=None, inputs=None,
                 enodes_base=None, existing_base=None):
        # nodes are snapshotted BEFORE pods are listed: a pod that binds in
        # between appears both as pending and in its node's usage, which
        # over-provisions (safe); the reverse order would under-provision
        # (provisioner.go:318-329). The disruption simulation passes its own
        # candidate-free snapshot (disruption/helpers.go:51).
        live_batch = pods is None  # explicit pods = a disruption simulation
        if state_nodes is None:
            state_nodes = self.cluster.nodes() if self.cluster is not None else []
        if pods is None:
            with obs.span("provision.pending"):
                pods = self.pending_pods()
                pods.extend(self.deleting_node_pods(state_nodes, pods))
            if not pods:
                return None
        # disruption simulations may hand in the round's cached solver
        # inputs (ops/consolidate.py SnapshotCache.inputs_for) — identical
        # content to a fresh assembly within one cluster-state generation,
        # which the cache verifies before releasing them
        if inputs is not None:
            templates, its_by_pool, overhead, limits, domains = inputs
        else:
            with obs.span("provision.inputs", kind="cache"):
                templates, its_by_pool, overhead, limits, domains = (
                    self.solver_inputs()
                )

        # pods with unresolvable PVCs can't schedule: report and drop from
        # the batch (ValidatePersistentVolumeClaims, volumetopology.go:155)
        from karpenter_tpu_torch.operator import metrics as m
        from karpenter_tpu_torch.scheduling.volumetopology import (
            PVCError,
            VolumeTopology,
        )

        vt = VolumeTopology(self.store)
        valid_pods = []
        with obs.span("provision.volumes", pods=len(pods)):
            for p in pods:
                try:
                    vt.validate(p)
                    valid_pods.append(p)
                except PVCError as e:
                    if self.recorder is not None:
                        self.recorder.publish("FailedScheduling", str(e),
                                              obj=p)
        # provisioning/metrics.go: queue depth at solve entry + pods the
        # batch dropped as unresolvable. Only the LIVE batch reports —
        # disruption counterfactuals must not clobber the gauges (the
        # reference mutes its simulations the same way, helpers.go:84)
        if live_batch:
            self.registry.gauge(
                m.SCHEDULING_QUEUE_DEPTH, "pods entering the solve"
            ).set(len(valid_pods))
            self.registry.gauge(
                m.IGNORED_PODS, "pods ignored this batch (unresolvable PVCs)"
            ).set(len(pods) - len(valid_pods))
        pods = valid_pods
        if not pods:
            # explicit-pods callers (disruption simulation) expect a results
            # object, never None — an all-filtered batch solves to nothing
            from karpenter_tpu_torch.models.scheduler import SchedulerResults

            return SchedulerResults(new_claims=[], existing_nodes=[], pod_errors={})
        view = (
            ClusterStateView(self.cluster, self.store)
            if self.cluster is not None
            else StoreClusterView(self.store)
        )
        with obs.span("provision.topology"):
            topology = Topology(cluster=view, domains=domains, pods=pods)
        with obs.span("provision.existing"):
            if enodes_base is not None:
                # disruption fast path (helpers.simulate_scheduling): the
                # round's snapshot bundle supplies generation-current
                # ExistingNode prototypes; forking re-binds them to THIS
                # solve's topology and fresh mutable state, skipping the
                # O(E) constructor sweep per confirming simulation
                existing_nodes = [en.fork(topology) for en in enodes_base]
            else:
                existing_nodes = self._existing_nodes(state_nodes, topology)
        # live batches with admission markers (pod priorities, gang
        # annotations, a tiering default class) route through the
        # admission plane — the tiered cascade, gang atomicity, and the
        # preemption ladder (karpenter_tpu_torch/admission). Disruption
        # counterfactuals and marker-free batches keep the single solve.
        plane = self.admission_plane() if live_batch else None
        if plane is not None and plane.engages(pods):
            with obs.span("provision.admission", pods=len(pods)):
                results = plane.solve_round(
                    self.solver,
                    pods,
                    templates,
                    its_by_pool,
                    topology=topology,
                    existing_nodes=existing_nodes,
                    daemon_overhead=overhead,
                    limits=limits or None,
                    volume_topology=vt,
                )
        else:
            results = self.solver.solve(
                pods,
                templates,
                its_by_pool,
                topology=topology,
                existing_nodes=existing_nodes,
                daemon_overhead=overhead,
                limits=limits or None,
                volume_topology=vt,
                existing_base=existing_base,
            )
        # host-routed accounting (live batches only — disruption
        # counterfactuals must not inflate the counter, helpers.go:84
        # stance): pods the device compiler handed to the host engine,
        # by reason
        if live_batch:
            # admission rounds aggregate host-routed reasons across the
            # whole cascade (the solver's last_device_stats only reflects
            # its final inner call); plain rounds read the solver directly
            adm = getattr(results, "admission", None)
            if adm is not None:
                routed = adm.get("host_routed") or {}
            else:
                routed = getattr(
                    self.solver, "last_device_stats", None
                ) or {}
                routed = routed.get("host_routed") or {}
            if routed:
                ctr = self.registry.counter(
                    m.PROVISIONING_HOST_ROUTED,
                    "pods routed to the host engine per live solve, by reason",
                )
                for reason, count in routed.items():
                    if count:
                        ctr.inc(count, reason=reason)
                # anomaly trigger: a live batch leaving the device path is
                # the grid-regression signature. The calibrated crossovers
                # are exempt: routing a tiny batch to the host/C++ engine
                # (small-batch) or having no ready nodepool (no-templates)
                # is by design
                refused = {
                    r: n for r, n in routed.items()
                    if r not in ("small-batch", "no-templates")
                }
                total_refused = sum(refused.values())
                if total_refused:
                    obs.anomaly(
                        "host-routed", registry=self.registry,
                        pods=total_refused,
                        reasons=",".join(sorted(refused)),
                    )
        evals, hits = truncate_stats["compat_evals"], truncate_stats["memo_hits"]
        with obs.span("provision.truncate", claims=len(results.new_claims)) as sp:
            results.truncate_instance_types()
            if sp is not None:
                sp.attrs["compat_evals"] = truncate_stats["compat_evals"] - evals
                sp.attrs["memo_hits"] = truncate_stats["memo_hits"] - hits
        return results

    def admission_plane(self):
        """The admission plane (priority tiers / gangs / preemption),
        built lazily — marker-free fleets never pay the import."""
        if self._admission is None:
            from karpenter_tpu_torch.admission import AdmissionPlane

            self._admission = AdmissionPlane(
                self.store, registry=self.registry, recorder=self.recorder,
                log=self.log,
            )
        return self._admission

    def solver_inputs(self):
        """Per-nodepool solver inputs: (templates, instance types by pool,
        daemon overhead, remaining limits, topology domain universe) — the
        NewScheduler assembly (scheduler.go:160-230), shared by the solve
        path and the batched consolidation probe."""
        nodepools = [np for np in self.store.list("nodepools") if nodepool_ready(np)]
        templates, its_by_pool, overhead, limits = [], {}, {}, {}
        domains: dict = {}
        for np in nodepools:
            its = self.cloud.get_instance_types(np)
            if not its:
                continue
            template = ClaimTemplate(np)
            templates.append(template)
            its_by_pool[np.name] = its
            self._collect_domains(domains, template, its)
            overhead[np.name] = self._daemon_overhead(template)
            if np.spec.limits:
                in_use = self._nodepool_usage(np)
                limits[np.name] = {
                    r: v - in_use.get(r, 0.0)
                    for r, v in resutil.parse_resources(np.spec.limits).items()
                }
        return templates, its_by_pool, overhead, limits, domains

    def _collect_domains(self, domains, template, instance_types):
        collect_domains(domains, template, instance_types)

    def _daemon_overhead(self, template) -> dict:
        """Sum of daemonset pod requests that would land on this pool's
        nodes (scheduler.go:335 getDaemonOverhead)."""
        total: dict = {}
        for ds in self.store.list("daemonsets"):
            p = ds.template
            if p is None:
                continue
            if not daemon_schedulable(
                p, template.taints, template.requirements, allow_undefined=wk.WELL_KNOWN_LABELS
            ):
                continue
            total = resutil.merge(total, p.effective_requests())
        return total

    def _nodepool_usage(self, np) -> dict:
        # live aggregation, not status.resources: the counter controller's
        # status snapshot lags within a reconcile round, and a stale zero
        # would let a launch overshoot the limit (the reference tolerates
        # this transient; we don't have to)
        from karpenter_tpu_torch.controllers.nodepool.counter import aggregate_pool_usage

        return aggregate_pool_usage(self.store, np)

    def deleting_node_pods(self, state_nodes, already: list) -> list:
        """Reschedulable pods bound to nodes being drained or marked for
        deletion: capacity must be pre-provisioned for them
        (provisioner.go:340 GetPodsFromNodes)."""
        seen = {p.uid for p in already}
        out = []
        for sn in state_nodes:
            if not (sn.deleting() or sn.marked_for_deletion):
                continue
            for p in sn.reschedulable_pods():
                if p.uid not in seen:
                    out.append(p)
        return out

    def _existing_nodes(self, state_nodes, topology):
        """Existing/in-flight capacity as scheduling targets, each carrying
        the daemonset requests that will land on it (scheduler.go
        NewScheduler's per-node daemon filtering)."""
        from karpenter_tpu_torch.models.existing import ExistingNode

        from karpenter_tpu_torch.scheduling import label_requirements

        daemons = [ds.template for ds in self.store.list("daemonsets") if ds.template is not None]
        out = []
        for sn in state_nodes:
            if sn.marked_for_deletion or sn.deleting():
                continue
            taints = sn.taints()
            node_reqs = label_requirements(sn.labels()) if daemons else None
            daemon_resources: dict = {}
            for p in daemons:
                if daemon_schedulable(p, taints, node_reqs):
                    daemon_resources = resutil.merge(daemon_resources, p.effective_requests())
            out.append(ExistingNode(sn, topology, daemon_resources, kube=self.store))
        return out

    # -- claim creation (provisioner.go CreateNodeClaims:149) ------------
    def create_node_claims(self, results) -> bool:
        from karpenter_tpu_torch.operator import metrics as m

        created = False
        for claim in results.new_claims:
            nc = claim.to_node_claim()
            self.store.create("nodeclaims", nc)
            self.registry.counter(m.NODECLAIMS_CREATED, "nodeclaims created").inc(
                nodepool=claim.template.nodepool_name)
            created = True
            for p in claim.pods:
                if p.node_name:
                    continue  # drain pre-provisioning: pod is still bound
                p.nominated_node_name = nc.name
                self.store.update("pods", p)
        # pods placed on existing capacity are nominated so the next solve
        # round doesn't re-provision for them (Results.Record, scheduler.go:96)
        for node in results.existing_nodes:
            pods = getattr(node, "scheduled_pods", None) or []
            for p in pods:
                if p.node_name:
                    continue  # drain pre-provisioning: pod is still bound
                p.nominated_node_name = node.name
                self.store.update("pods", p)
            if pods and self.cluster is not None:
                self.cluster.nominate(node.name)
        if results.new_claims:
            # provisioner.go:149's "created nodeclaim" log line, one per round
            self.log.info(
                "launched nodeclaims",
                claims=len(results.new_claims),
                pods=sum(len(c.pods) for c in results.new_claims),
                pools=",".join(sorted({
                    c.template.nodepool_name for c in results.new_claims})),
            )
        for pod_key, err in results.pod_errors.items():
            if self.recorder is not None and self._change_monitor.has_changed(
                pod_key, err
            ):
                # emit-on-change (pretty.ChangeMonitor): a pod stuck with
                # the SAME error re-solves every batch but reports once;
                # a different error (or a day of stasis) reports again
                self.recorder.publish(
                    "FailedScheduling", f"pod {pod_key} incompatible: {err}"
                )
        # pods that scheduled this round (onto new claims OR existing
        # capacity) drop out of the monitor so a later relapse reports
        # immediately
        for claim in results.new_claims:
            for p in claim.pods:
                self._change_monitor.forget(p.key())
        for node in results.existing_nodes:
            for p in getattr(node, "scheduled_pods", None) or []:
                self._change_monitor.forget(p.key())
        return created
