"""Test-double CloudProvider.

Mirrors pkg/cloudprovider/fake/cloudprovider.go:47-158: records calls,
supports injectable next-errors and a create budget, and synthesizes
NodeClaims from the cheapest compatible offering.

The port's copy of ``karpenter_tpu/cloudprovider/fake.py`` (imports
changed).
"""

from __future__ import annotations

import copy
import threading

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_tpu_torch.api.objects import new_uid
from karpenter_tpu_torch.cloudprovider.catalog import kwok_catalog
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    cheapest_effective_offering,
)
from karpenter_tpu_torch.scheduling import Requirements, node_selector_requirements


class FakeCloudProvider(CloudProvider):
    def __init__(self, instance_types=None):
        self.instance_types = instance_types if instance_types is not None else kwok_catalog()
        self.created: dict = {}  # provider_id -> NodeClaim
        self.create_calls: list = []
        self.delete_calls: list = []
        self.next_create_err: Exception | None = None
        self.next_delete_err: Exception | None = None
        self.next_get_err: Exception | None = None
        self.allowed_create_calls: int | None = None
        self.drifted: str = ""  # reason returned by is_drifted for all claims
        self._lock = threading.Lock()

    def name(self) -> str:
        return "fake"

    def get_instance_types(self, node_pool) -> list:
        return list(self.instance_types)

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        with self._lock:
            if self.next_create_err is not None:
                err, self.next_create_err = self.next_create_err, None
                raise err
            if self.allowed_create_calls is not None and len(self.create_calls) >= self.allowed_create_calls:
                raise InsufficientCapacityError("create budget exhausted")
            self.create_calls.append(node_claim)
            reqs = node_selector_requirements(node_claim.spec.requirements)
            choice = self._cheapest(reqs, node_claim.spec.resource_requests)
            if choice is None:
                raise InsufficientCapacityError("no compatible instance type")
            it, offering = choice
            claim = copy.deepcopy(node_claim)
            claim.status.provider_id = f"fake://{new_uid('instance')}"
            claim.status.capacity = dict(it.capacity)
            claim.status.allocatable = dict(it.allocatable())
            # offering-derived labels are authoritative: they reflect where
            # the instance actually launched, so they spread last
            offering_labels = {
                wk.INSTANCE_TYPE_LABEL: it.name,
                wk.TOPOLOGY_ZONE_LABEL: offering.zone,
                wk.CAPACITY_TYPE_LABEL: offering.capacity_type,
            }
            claim.metadata.labels = {
                **node_claim.metadata.labels,
                **{k: v for k, v in reqs.labels().items() if k not in offering_labels},
                **offering_labels,
            }
            self.created[claim.status.provider_id] = claim
            return claim

    def _cheapest(self, reqs: Requirements, requests: dict):
        # cheapest EFFECTIVE offering (the shared launch-placement rule)
        return cheapest_effective_offering(self.instance_types, reqs,
                                           requests)

    def delete(self, node_claim: NodeClaim) -> None:
        with self._lock:
            if self.next_delete_err is not None:
                err, self.next_delete_err = self.next_delete_err, None
                raise err
            self.delete_calls.append(node_claim)
            if node_claim.status.provider_id not in self.created:
                raise NodeClaimNotFoundError(node_claim.status.provider_id)
            del self.created[node_claim.status.provider_id]

    def get(self, provider_id: str) -> NodeClaim:
        with self._lock:
            if self.next_get_err is not None:
                err, self.next_get_err = self.next_get_err, None
                raise err
            claim = self.created.get(provider_id)
            if claim is None:
                raise NodeClaimNotFoundError(provider_id)
            return claim

    def list(self) -> list:
        with self._lock:
            return list(self.created.values())

    def is_drifted(self, node_claim) -> str:
        return self.drifted
