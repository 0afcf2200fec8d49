"""NodeClaim: one requested/owned machine.

Field semantics from the reference's pkg/apis/v1beta1/nodeclaim.go
(NodeClaimSpec :26, NodeSelectorRequirementWithMinValues :60) and
nodeclaim_status.go (providerID, capacity/allocatable, conditions
Launched/Registered/Initialized plus disruption conditions
Drifted/Empty/Expired set by pkg/controllers/nodeclaim/disruption).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.api.conditions import Condition, ConditionedObject
from karpenter_tpu_torch.api.objects import ObjectMeta

__all__ = [
    "Condition",
    "NodeClaim",
    "NodeClaimSpec",
    "NodeClaimStatus",
]

# condition types
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_DRIFTED = "Drifted"
COND_EMPTY = "Empty"
COND_EXPIRED = "Expired"
COND_CONSISTENT = "ConsistentStateFound"
COND_TERMINATING = "Terminating"


@dataclass
class NodeClaimSpec:
    taints: list = field(default_factory=list)  # [Taint]
    startup_taints: list = field(default_factory=list)
    requirements: list = field(default_factory=list)  # [NodeSelectorRequirement]
    resource_requests: dict = field(default_factory=dict)
    kubelet: dict = field(default_factory=dict)
    node_class_ref: dict = field(default_factory=dict)
    terminate_after: float | None = None


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    image_id: str = ""
    node_name: str = ""
    capacity: dict = field(default_factory=dict)
    allocatable: dict = field(default_factory=dict)
    conditions: list = field(default_factory=list)  # [Condition]


@dataclass
class NodeClaim(ConditionedObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def launched(self) -> bool:
        return self.is_true(COND_LAUNCHED)

    @property
    def registered(self) -> bool:
        return self.is_true(COND_REGISTERED)

    @property
    def initialized(self) -> bool:
        return self.is_true(COND_INITIALIZED)
