"""The host-plane scheduling loop (first-fit-decreasing).

Behavioral mirror of the reference's Scheduler.Solve
(pkg/controllers/provisioning/scheduling/scheduler.go:195-296): pop pods in
FFD order; try existing nodes, then open claims sorted by ascending pod
count, then a new claim per weight-ordered template (respecting nodepool
limits via remaining-resource filtering); on failure relax preferences and
requeue. This loop is both the semantic oracle for the device kernel and the
no-accelerator fallback solver.
"""

from __future__ import annotations

from karpenter_tpu_torch.cloudprovider.offering_table import OfferingTable
from karpenter_tpu_torch.models.inflight import ClaimTemplate, InFlightNodeClaim
from karpenter_tpu_torch.models.preferences import Preferences
from karpenter_tpu_torch.models.queue import SchedulingQueue
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.utils import resources as resutil


class NullTopology:
    """Topology hooks when no topology constraints are in play (M2 supplies
    the real implementation)."""

    def add_requirements(self, strict_pod_reqs, node_reqs, pod, allow_undefined=None):
        return Requirements(), None

    def record(self, pod, reqs, allow_undefined=None):
        pass

    def update(self, pod):
        return None

    def register(self, topology_key, domain):
        pass


class SchedulerResults:
    """Solve output (scheduler.go Results:96)."""

    def __init__(self, new_claims, existing_nodes, pod_errors):
        self.new_claims = new_claims
        self.existing_nodes = existing_nodes
        self.pod_errors = pod_errors

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors

    def truncate_instance_types(self, max_items=None):
        """Truncate every new claim's types from one offering table over
        the union of their types (cloudprovider/offering_table.py)."""
        from karpenter_tpu_torch.models.inflight import MAX_INSTANCE_TYPES

        table = OfferingTable(it for c in self.new_claims for it in c.instance_types)
        for claim in self.new_claims:
            claim.truncate_instance_types(max_items or MAX_INSTANCE_TYPES, table=table)
        return self

    def node_count(self) -> int:
        return len(self.new_claims)

    def scheduled_pod_count(self) -> int:
        n = sum(len(c.pods) for c in self.new_claims)
        n += sum(len(getattr(e, "scheduled_pods", [])) for e in self.existing_nodes)
        return n


def filter_by_remaining_resources(instance_types, remaining: dict | None):
    """Drop types whose full capacity would breach the nodepool's remaining
    limits; only the limited resource names constrain
    (scheduler.go filterByRemainingResources:378)."""
    if remaining is None:
        return list(instance_types)
    return [
        it
        for it in instance_types
        if all(it.capacity.get(r, 0.0) <= v + 1e-9 for r, v in remaining.items())
    ]


def subtract_max(remaining: dict, instance_types) -> dict:
    """Subtract the worst-case (max per-resource) capacity of the claim's
    remaining types; only limited resource names are tracked
    (scheduler.go subtractMax)."""
    worst = resutil.max_resources(*[it.capacity for it in instance_types])
    return {r: v - worst.get(r, 0.0) for r, v in remaining.items()}


class Scheduler:
    def __init__(
        self,
        templates,  # [ClaimTemplate] in weight order
        instance_types: dict,  # nodepool name -> [InstanceType]
        topology=None,
        existing_nodes=(),
        daemon_overhead: dict | None = None,  # nodepool name -> ResourceList
        remaining_resources: dict | None = None,  # nodepool name -> ResourceList (limits)
        recorder=None,
        volume_topology=None,  # VolumeTopology: PV/SC zone pins (volumetopology.go:42)
    ):
        self.templates = sorted(templates, key=lambda t: (-t.weight, t.nodepool_name))
        self.instance_types = instance_types
        self.topology = topology or NullTopology()
        self.existing_nodes = list(existing_nodes)
        self.daemon_overhead = daemon_overhead or {}
        self.remaining_resources = dict(remaining_resources or {})
        self.preferences = Preferences()
        self.recorder = recorder
        self.volume_topology = volume_topology
        self.new_claims: list = []

    def solve(self, pods) -> SchedulerResults:
        # relaxation mutates pod specs in place; work on clones so a caller
        # can re-solve the same input and get the same answer, but hand the
        # caller's own objects back in the results
        originals = {p.uid: p for p in pods}
        pods = [p.clone() for p in pods]
        if self.volume_topology is not None:
            # zone pins from bound PVs / storage classes AND into the
            # clones' node affinity; the caller's objects stay untouched
            for p in pods:
                self.volume_topology.inject(p)
        errors: dict = {}
        pod_by_uid = {}
        q = SchedulingQueue(pods)
        while True:
            pod = q.pop()
            if pod is None:
                break
            pod_by_uid[pod.uid] = pod
            err = self._add(pod)
            errors[pod.uid] = err
            if err is None:
                continue
            # relax preferences and recompute topology (scheduler.go:223)
            relaxed = self.preferences.relax(pod)
            q.push(pod, relaxed)
            if relaxed:
                self.topology.update(pod)
        for claim in self.new_claims:
            claim.finalize()
            claim.pods = [originals.get(p.uid, p) for p in claim.pods]
        for node in self.existing_nodes:
            if hasattr(node, "pods"):
                node.pods = [originals.get(p.uid, p) for p in node.pods]
        pod_errors = {
            uid: err for uid, err in errors.items() if err is not None
        }
        return SchedulerResults(
            new_claims=self.new_claims,
            existing_nodes=self.existing_nodes,
            pod_errors={pod_by_uid[uid].key(): e for uid, e in pod_errors.items()},
        )

    def _add(self, pod) -> str | None:
        # 1. in-flight real nodes first (scheduler.go:250)
        for node in self.existing_nodes:
            if node.add(pod) is None:
                return None
        # 2. open claims, emptiest first (scheduler.go:258)
        self.new_claims.sort(key=lambda c: len(c.pods))
        for claim in self.new_claims:
            if claim.add(pod) is None:
                return None
        # 3. new claim per template in weight order (scheduler.go:267)
        errs = []
        for template in self.templates:
            its = self.instance_types.get(template.nodepool_name, [])
            remaining = self.remaining_resources.get(template.nodepool_name)
            if remaining is not None:
                its = filter_by_remaining_resources(its, remaining)
                if not its:
                    errs.append(
                        f'all available instance types exceed limits for nodepool: "{template.nodepool_name}"'
                    )
                    continue
            claim = InFlightNodeClaim(
                template,
                self.topology,
                self.daemon_overhead.get(template.nodepool_name, {}),
                its,
            )
            err = claim.add(pod)
            if err is not None:
                errs.append(f'incompatible with nodepool "{template.nodepool_name}", {err}')
                continue
            self.new_claims.append(claim)
            if remaining is not None:
                self.remaining_resources[template.nodepool_name] = subtract_max(
                    remaining, claim.instance_types
                )
            return None
        return "; ".join(errs) if errs else "no nodepool available"
