"""kwok-style provider: nodes materialize directly in the object store.

Mirror of the reference's kwok provider (kwok/cloudprovider/
cloudprovider.go:54-188): Create picks the cheapest compatible offering and
fabricates the Node object itself (there is no kubelet), Delete/Get/List
operate on those objects, and the catalog is the synthetic generated one.
This is the e2e vehicle for the hermetic cluster (kube/store.py).

The port's copy of ``karpenter_tpu/cloudprovider/kwok.py`` (imports changed).
"""

from __future__ import annotations

import copy

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_tpu_torch.api.objects import Node, ObjectMeta, Taint
from karpenter_tpu_torch.cloudprovider.catalog import kwok_catalog
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    cheapest_effective_offering,
)
from karpenter_tpu_torch.scheduling import node_selector_requirements

UNREGISTERED_TAINT = Taint(key=wk.UNREGISTERED_TAINT_KEY, effect="NoExecute")


class KwokCloudProvider(CloudProvider):
    def __init__(self, store, instance_types=None, ready_delay: float = 0.0):
        self.store = store
        self.instance_types = instance_types if instance_types is not None else kwok_catalog()
        self.ready_delay = ready_delay
        self.created: dict = {}  # provider_id -> NodeClaim

    def name(self) -> str:
        return "kwok"

    def get_instance_types(self, node_pool) -> list:
        return list(self.instance_types)

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        reqs = node_selector_requirements(node_claim.spec.requirements)
        # launch placement is risk-aware (the shared
        # cheapest_effective_offering rule): a λ > 0 deployment buys
        # low-interruption-risk capacity; λ=0 keeps the nominal cheapest
        best = cheapest_effective_offering(
            self.instance_types, reqs, node_claim.spec.resource_requests)
        if best is None:
            raise InsufficientCapacityError(
                f"no instance type available for claim {node_claim.name}"
            )
        it, offering = best

        claim = copy.deepcopy(node_claim)
        node_name = node_claim.name
        claim.status.provider_id = f"kwok://{node_name}"
        claim.status.node_name = node_name
        claim.status.capacity = dict(it.capacity)
        claim.status.allocatable = dict(it.allocatable())

        labels = {
            **claim.metadata.labels,
            wk.INSTANCE_TYPE_LABEL: it.name,
            wk.TOPOLOGY_ZONE_LABEL: offering.zone,
            wk.CAPACITY_TYPE_LABEL: offering.capacity_type,
            wk.HOSTNAME_LABEL: node_name,
        }
        claim.metadata.labels = labels
        # kwok has no kubelet: fabricate the Node (cloudprovider.go toNode:140)
        node = Node(
            metadata=ObjectMeta(name=node_name, namespace="", labels=dict(labels)),
            provider_id=claim.status.provider_id,
            taints=[UNREGISTERED_TAINT] + list(claim.spec.taints),
            startup_taints=list(claim.spec.startup_taints),
            capacity=dict(it.capacity),
            allocatable=dict(it.allocatable()),
            ready=self.ready_delay <= 0,
        )
        if self.store.try_get("nodes", node_name) is None:
            self.store.create("nodes", node)
        self.created[claim.status.provider_id] = claim
        return claim

    def delete(self, node_claim: NodeClaim) -> None:
        pid = node_claim.status.provider_id
        if pid not in self.created:
            raise NodeClaimNotFoundError(pid)
        del self.created[pid]
        node = self.store.try_get("nodes", node_claim.status.node_name or node_claim.name)
        if node is not None:
            self.store.delete("nodes", node)

    def get(self, provider_id: str) -> NodeClaim:
        claim = self.created.get(provider_id)
        if claim is None:
            raise NodeClaimNotFoundError(provider_id)
        return claim

    def list(self) -> list:
        return list(self.created.values())

    def is_drifted(self, node_claim) -> str:
        return ""
