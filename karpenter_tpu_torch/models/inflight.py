"""In-flight NodeClaim simulation: the unit of bin-packing.

Behavioral mirror of the reference's scheduling NodeClaim
(pkg/controllers/provisioning/scheduling/nodeclaim.go:65-120: taints →
host ports → requirement compatibility → topology tightening → instance-type
filtering) and NodeClaimTemplate (nodeclaimtemplate.go:39-61). A claim keeps
EVERY instance type still feasible for its accumulated pods; its effective
capacity is therefore the max over remaining types, which the device pack
kernel (ops/kernels.py) replicates.
"""

from __future__ import annotations

import itertools

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    filter_instance_types,
    satisfies_min_values,
)
from karpenter_tpu_torch.cloudprovider.offering_table import OfferingTable
from karpenter_tpu_torch.scheduling import (
    IN,
    HostPortUsage,
    Requirement,
    Requirements,
    Taints,
    has_preferred_node_affinity,
    label_requirements,
    node_selector_requirements,
    pod_requirements,
    strict_pod_requirements,
)
from karpenter_tpu_torch.utils import resources as resutil

_hostname_counter = itertools.count(1)

# Instance types kept on a launched claim (nodeclaimtemplate.go:34)
MAX_INSTANCE_TYPES = 60


class ClaimTemplate:
    """NodePool → stamped claim template (nodeclaimtemplate.go:39)."""

    def __init__(self, node_pool):
        self.node_pool = node_pool
        self.nodepool_name = node_pool.name
        self.weight = node_pool.spec.weight
        t = node_pool.spec.template
        self.labels = dict(t.labels)
        # claims carry the pool's static-field hash; the drift condition
        # controller compares it against the pool's current annotation
        # (nodeclaimtemplate.go stamps karpenter.sh/nodepool-hash)
        self.annotations = {
            **t.annotations,
            wk.NODEPOOL_HASH_ANNOTATION: node_pool.static_hash(),
            wk.NODEPOOL_HASH_VERSION_ANNOTATION: wk.NODEPOOL_HASH_VERSION,
        }
        self.taints = Taints(t.taints)
        self.startup_taints = Taints(t.startup_taints)
        self.kubelet = dict(t.kubelet)
        self.node_class_ref = dict(t.node_class_ref)
        self.requirements = Requirements()
        self.requirements.add(*node_selector_requirements(t.requirements).values())
        self.requirements.add(*label_requirements(t.labels).values())
        self.requirements.add(Requirement(wk.NODEPOOL_LABEL, IN, [node_pool.name]))


class InFlightNodeClaim:
    """One hypothetical node being packed (scheduling/nodeclaim.go)."""

    def __init__(self, template: ClaimTemplate, topology, daemon_resources: dict, instance_types, requirements=None):
        self.template = template
        self.topology = topology
        self.daemon_resources = dict(daemon_resources or {})
        self.instance_types = list(instance_types)
        self.pods: list = []
        self.requests = dict(self.daemon_resources)
        # `requirements` lets the device decoder hand over the bin's merged
        # set directly (it already contains the template's), skipping a
        # copy per decoded claim; the set is owned by the claim afterwards
        self.requirements = (
            template.requirements.copy() if requirements is None else requirements
        )
        # nodes need hostnames for hostname-topology purposes; dropped at
        # finalize (scheduler.go FinalizeScheduling)
        self.hostname = f"hostname-{next(_hostname_counter)}"
        self.requirements.add(Requirement(wk.HOSTNAME_LABEL, IN, [self.hostname]))
        topology.register(wk.HOSTNAME_LABEL, self.hostname)  # nodeclaim.go:49
        self.taints = Taints(template.taints)
        self.host_ports = HostPortUsage()

    def add(self, pod) -> str | None:
        """Try to schedule pod onto this claim; returns error string or None.
        Mutates only on success (nodeclaim.go Add:65)."""
        err = self.taints.tolerates(pod)
        if err:
            return err
        err = self.host_ports.conflicts(pod)
        if err:
            return f"checking host port usage, {err}"

        claim_reqs = self.requirements.copy()
        pod_reqs = pod_requirements(pod)
        err = claim_reqs.compatible(pod_reqs, allow_undefined=wk.WELL_KNOWN_LABELS)
        if err:
            return f"incompatible requirements, {err}"
        claim_reqs.add(*pod_reqs.values())

        # preferred node affinity must not restrict topology domains
        strict = strict_pod_requirements(pod) if has_preferred_node_affinity(pod) else pod_reqs
        topo_reqs, err = self.topology.add_requirements(
            strict, claim_reqs, pod, allow_undefined=wk.WELL_KNOWN_LABELS
        )
        if err:
            return err
        err = claim_reqs.compatible(topo_reqs, allow_undefined=wk.WELL_KNOWN_LABELS)
        if err:
            return err
        claim_reqs.add(*topo_reqs.values())

        requests = resutil.merge(self.requests, pod.effective_requests())
        remaining = filter_instance_types(self.instance_types, claim_reqs, requests)
        if remaining and claim_reqs.has_min_values():
            _, mv_err = satisfies_min_values(remaining, claim_reqs)
            if mv_err:
                remaining = []
        if not remaining:
            return (
                f"no instance type satisfied resources {requests} and "
                f"requirements {claim_reqs}"
            )

        self.pods.append(pod)
        self.instance_types = remaining
        self.requests = requests
        self.requirements = claim_reqs
        self.topology.record(pod, claim_reqs, allow_undefined=wk.WELL_KNOWN_LABELS)
        self.host_ports.add(pod)
        return None

    def finalize(self):
        """Drop the synthetic hostname requirement before launch
        (nodeclaim.go FinalizeScheduling)."""
        self.requirements.pop(wk.HOSTNAME_LABEL, None)

    def truncate_instance_types(self, max_items: int = MAX_INSTANCE_TYPES, table=None):
        """Keep the ``max_items`` cheapest types (types.py
        ``truncate_instance_types``), read from ``table``, an
        :class:`OfferingTable` over at least this claim's types; one of
        its own where None."""
        if table is None:
            table = OfferingTable(self.instance_types)
        out, err = table.truncate(self.instance_types, self.requirements, max_items)
        if err is None:
            self.instance_types = out
        return err

    def to_node_claim(self):
        """Emit the launchable NodeClaim object (nodeclaimtemplate.go
        ToNodeClaim:39-61)."""
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim, NodeClaimSpec
        from karpenter_tpu_torch.api.objects import ObjectMeta, new_uid

        reqs = [r.to_node_selector_requirement() for r in self.requirements.values()]
        name = f"{self.template.nodepool_name}-{new_uid('claim')}"
        labels = {
            **self.template.labels,
            **self.requirements.labels(),
            wk.NODEPOOL_LABEL: self.template.nodepool_name,
        }
        return NodeClaim(
            metadata=ObjectMeta(
                name=name,
                namespace="",
                labels=labels,
                annotations=dict(self.template.annotations),
                finalizers=[wk.TERMINATION_FINALIZER],
            ),
            spec=NodeClaimSpec(
                taints=list(self.template.taints),
                startup_taints=list(self.template.startup_taints),
                requirements=reqs,
                resource_requests=dict(self.requests),
                kubelet=dict(self.template.kubelet),
                node_class_ref=dict(self.template.node_class_ref),
            ),
        )

    @property
    def price_floor(self) -> float:
        """Cheapest possible launch price among remaining options."""
        best = float("inf")
        for it in self.instance_types:
            ofs = it.offerings.available().compatible(self.requirements)
            if ofs:
                best = min(best, ofs.cheapest().price)
        return best

    def __repr__(self):
        return (
            f"InFlightNodeClaim(pool={self.template.nodepool_name}, pods={len(self.pods)}, "
            f"types={len(self.instance_types)})"
        )
