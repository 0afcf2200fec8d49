from karpenter_tpu_torch.api import labels  # noqa: F401
from karpenter_tpu_torch.api.objects import (  # noqa: F401
    Node,
    ObjectMeta,
    Pod,
    PodDisruptionBudget,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.api.nodeclaim import NodeClaim, NodeClaimSpec, NodeClaimStatus  # noqa: F401
from karpenter_tpu_torch.api.nodepool import (  # noqa: F401
    Budget,
    Disruption,
    NodePool,
    NodePoolSpec,
    NodePoolStatus,
)

__all__ = [
    "labels",
    "Node", "ObjectMeta", "Pod", "PodDisruptionBudget", "Taint",
    "Toleration", "TopologySpreadConstraint",
    "NodeClaim", "NodeClaimSpec", "NodeClaimStatus",
    "Budget", "Disruption", "NodePool", "NodePoolSpec", "NodePoolStatus",
]
