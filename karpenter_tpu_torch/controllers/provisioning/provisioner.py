"""Provisioner: the scheduler-input assembly over a live cluster.

Mirror of the reference's pkg/controllers/provisioning/provisioner.go:
the scheduler inputs (NewScheduler :219-314 — ready nodepools by weight,
per-pool instance types, the topology domain universe :264-296, daemonset
overhead, remaining nodepool limits) and the existing-node targets.

The port's copy of part of ``karpenter_tpu/controllers/provisioning/
provisioner.py`` (imports changed): the cluster-state views, ``collect_
domains``, ``nodepool_ready`` and the ``Provisioner`` pieces the
disruption snapshot reads (``solver_inputs``, ``deleting_node_pods``,
``_existing_nodes``). Its solver defaults to ``TorchSolver()``. The
provisioning loop itself — ``reconcile``, ``schedule``,
``create_node_claims`` — is ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher
from karpenter_tpu_torch.models import ClaimTemplate
from karpenter_tpu_torch.scheduling import daemon_schedulable
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
                 recorder=None, cluster=None):
        from karpenter_tpu_torch.utils.clock import Clock

        self.store = store
        self.cloud = cloud
        self.clock = clock or Clock()
        if solver is None:
            from karpenter_tpu_torch.models.solver import TorchSolver

            solver = TorchSolver()
        self.solver = solver
        # the reference's 1s idle / 10s max debounce window (options.go:96-97)
        self.batcher = batcher or Batcher(self.clock)
        self.recorder = recorder
        self.cluster = cluster  # state plane; optional

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
