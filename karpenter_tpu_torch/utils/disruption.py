"""Disruption cost model.

Mirror of the reference's utils/disruption/disruption.go:37-78: a node's
disruption cost is the sum over its reschedulable pods of the pod's
eviction cost (priority-derived) scaled by the node's remaining lifetime
fraction — nodes close to expiry are cheap to disrupt.

The port's copy of ``karpenter_tpu/utils/disruption.py`` (imports changed).
"""

from __future__ import annotations

EVICTION_COST_ANNOTATION = "cluster-autoscaler.kubernetes.io/pod-eviction-cost"


def pod_eviction_cost(pod) -> float:
    """disruption.go GetPodEvictionCost: 1 + priority/1e6, overridden by the
    eviction-cost annotation, clamped to [-1e6, 1e6]."""
    cost = 1.0
    priority = pod.priority or 0
    cost += priority / 1e6
    raw = pod.metadata.annotations.get(EVICTION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost = float(raw)
        except ValueError:
            pass
    return min(max(cost, -1e6), 1e6)


def lifetime_remaining(state_node, expire_after: float | None, now: float) -> float:
    """Fraction of the node's lifetime left (disruption.go
    LifetimeRemaining): 1.0 when expiry is disabled."""
    if not expire_after:
        return 1.0
    node = state_node.node
    created = (
        node.metadata.creation_timestamp
        if node is not None
        else (
            state_node.node_claim.metadata.creation_timestamp
            if state_node.node_claim is not None
            else now
        )
    )
    remaining = 1.0 - (now - created) / expire_after
    return min(max(remaining, 0.0), 1.0)


def disruption_cost(pods, *, state_node=None, expire_after=None, now=0.0) -> float:
    cost = sum(pod_eviction_cost(p) for p in pods)
    if state_node is not None:
        cost *= lifetime_remaining(state_node, expire_after, now)
    return cost
